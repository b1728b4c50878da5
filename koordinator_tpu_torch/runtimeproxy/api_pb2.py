# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: api.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tapi.proto\x12\x1bkoordinator.runtimeproxy.v1\"\xd4\x02\n\x0ePodSandboxMeta\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x11\n\tnamespace\x18\x02 \x01(\t\x12\x0b\n\x03uid\x18\x03 \x01(\t\x12G\n\x06labels\x18\x04 \x03(\x0b\x32\x37.koordinator.runtimeproxy.v1.PodSandboxMeta.LabelsEntry\x12Q\n\x0b\x61nnotations\x18\x05 \x03(\x0b\x32<.koordinator.runtimeproxy.v1.PodSandboxMeta.AnnotationsEntry\x12\x15\n\rcgroup_parent\x18\x06 \x01(\t\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xa6\x02\n\rContainerMeta\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\n\n\x02id\x18\x02 \x01(\t\x12\x46\n\x06labels\x18\x03 \x03(\x0b\x32\x36.koordinator.runtimeproxy.v1.ContainerMeta.LabelsEntry\x12P\n\x0b\x61nnotations\x18\x04 \x03(\x0b\x32;.koordinator.runtimeproxy.v1.ContainerMeta.AnnotationsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xb3\x01\n\x17LinuxContainerResources\x12\x12\n\ncpu_period\x18\x01 \x01(\x03\x12\x11\n\tcpu_quota\x18\x02 \x01(\x03\x12\x12\n\ncpu_shares\x18\x03 \x01(\x03\x12\x1a\n\x12memory_limit_bytes\x18\x04 \x01(\x03\x12\x13\n\x0b\x63puset_cpus\x18\x05 \x01(\t\x12\x13\n\x0b\x63puset_mems\x18\x06 \x01(\t\x12\x17\n\x0f\x63pu_bvt_warp_ns\x18\x07 \x01(\x03\"\x9f\x01\n\x15PodSandboxHookRequest\x12=\n\x08pod_meta\x18\x01 \x01(\x0b\x32+.koordinator.runtimeproxy.v1.PodSandboxMeta\x12G\n\tresources\x18\x02 \x01(\x0b\x32\x34.koordinator.runtimeproxy.v1.LinuxContainerResources\"\x87\x02\n\x16PodSandboxHookResponse\x12Y\n\x0b\x61nnotations\x18\x01 \x03(\x0b\x32\x44.koordinator.runtimeproxy.v1.PodSandboxHookResponse.AnnotationsEntry\x12G\n\tresources\x18\x02 \x01(\x0b\x32\x34.koordinator.runtimeproxy.v1.LinuxContainerResources\x12\x15\n\rcgroup_parent\x18\x03 \x01(\t\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xe7\x02\n\x1c\x43ontainerResourceHookRequest\x12=\n\x08pod_meta\x18\x01 \x01(\x0b\x32+.koordinator.runtimeproxy.v1.PodSandboxMeta\x12\x42\n\x0e\x63ontainer_meta\x18\x02 \x01(\x0b\x32*.koordinator.runtimeproxy.v1.ContainerMeta\x12G\n\tresources\x18\x03 \x01(\x0b\x32\x34.koordinator.runtimeproxy.v1.LinuxContainerResources\x12O\n\x03\x65nv\x18\x04 \x03(\x0b\x32\x42.koordinator.runtimeproxy.v1.ContainerResourceHookRequest.EnvEntry\x1a*\n\x08\x45nvEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xfc\x02\n\x1d\x43ontainerResourceHookResponse\x12`\n\x0b\x61nnotations\x18\x01 \x03(\x0b\x32K.koordinator.runtimeproxy.v1.ContainerResourceHookResponse.AnnotationsEntry\x12G\n\tresources\x18\x02 \x01(\x0b\x32\x34.koordinator.runtimeproxy.v1.LinuxContainerResources\x12P\n\x03\x65nv\x18\x03 \x03(\x0b\x32\x43.koordinator.runtimeproxy.v1.ContainerResourceHookResponse.EnvEntry\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a*\n\x08\x45nvEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x32\xfa\x07\n\x12RuntimeHookService\x12\x7f\n\x14PreRunPodSandboxHook\x12\x32.koordinator.runtimeproxy.v1.PodSandboxHookRequest\x1a\x33.koordinator.runtimeproxy.v1.PodSandboxHookResponse\x12\x81\x01\n\x16PostStopPodSandboxHook\x12\x32.koordinator.runtimeproxy.v1.PodSandboxHookRequest\x1a\x33.koordinator.runtimeproxy.v1.PodSandboxHookResponse\x12\x8f\x01\n\x16PreCreateContainerHook\x12\x39.koordinator.runtimeproxy.v1.ContainerResourceHookRequest\x1a:.koordinator.runtimeproxy.v1.ContainerResourceHookResponse\x12\x8e\x01\n\x15PreStartContainerHook\x12\x39.koordinator.runtimeproxy.v1.ContainerResourceHookRequest\x1a:.koordinator.runtimeproxy.v1.ContainerResourceHookResponse\x12\x8f\x01\n\x16PostStartContainerHook\x12\x39.koordinator.runtimeproxy.v1.ContainerResourceHookRequest\x1a:.koordinator.runtimeproxy.v1.ContainerResourceHookResponse\x12\x98\x01\n\x1fPreUpdateContainerResourcesHook\x12\x39.koordinator.runtimeproxy.v1.ContainerResourceHookRequest\x1a:.koordinator.runtimeproxy.v1.ContainerResourceHookResponse\x12\x8e\x01\n\x15PostStopContainerHook\x12\x39.koordinator.runtimeproxy.v1.ContainerResourceHookRequest\x1a:.koordinator.runtimeproxy.v1.ContainerResourceHookResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'api_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PODSANDBOXMETA_LABELSENTRY._options = None
  _PODSANDBOXMETA_LABELSENTRY._serialized_options = b'8\001'
  _PODSANDBOXMETA_ANNOTATIONSENTRY._options = None
  _PODSANDBOXMETA_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINERMETA_LABELSENTRY._options = None
  _CONTAINERMETA_LABELSENTRY._serialized_options = b'8\001'
  _CONTAINERMETA_ANNOTATIONSENTRY._options = None
  _CONTAINERMETA_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _PODSANDBOXHOOKRESPONSE_ANNOTATIONSENTRY._options = None
  _PODSANDBOXHOOKRESPONSE_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINERRESOURCEHOOKREQUEST_ENVENTRY._options = None
  _CONTAINERRESOURCEHOOKREQUEST_ENVENTRY._serialized_options = b'8\001'
  _CONTAINERRESOURCEHOOKRESPONSE_ANNOTATIONSENTRY._options = None
  _CONTAINERRESOURCEHOOKRESPONSE_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINERRESOURCEHOOKRESPONSE_ENVENTRY._options = None
  _CONTAINERRESOURCEHOOKRESPONSE_ENVENTRY._serialized_options = b'8\001'
  _PODSANDBOXMETA._serialized_start=43
  _PODSANDBOXMETA._serialized_end=383
  _PODSANDBOXMETA_LABELSENTRY._serialized_start=286
  _PODSANDBOXMETA_LABELSENTRY._serialized_end=331
  _PODSANDBOXMETA_ANNOTATIONSENTRY._serialized_start=333
  _PODSANDBOXMETA_ANNOTATIONSENTRY._serialized_end=383
  _CONTAINERMETA._serialized_start=386
  _CONTAINERMETA._serialized_end=680
  _CONTAINERMETA_LABELSENTRY._serialized_start=286
  _CONTAINERMETA_LABELSENTRY._serialized_end=331
  _CONTAINERMETA_ANNOTATIONSENTRY._serialized_start=333
  _CONTAINERMETA_ANNOTATIONSENTRY._serialized_end=383
  _LINUXCONTAINERRESOURCES._serialized_start=683
  _LINUXCONTAINERRESOURCES._serialized_end=862
  _PODSANDBOXHOOKREQUEST._serialized_start=865
  _PODSANDBOXHOOKREQUEST._serialized_end=1024
  _PODSANDBOXHOOKRESPONSE._serialized_start=1027
  _PODSANDBOXHOOKRESPONSE._serialized_end=1290
  _PODSANDBOXHOOKRESPONSE_ANNOTATIONSENTRY._serialized_start=333
  _PODSANDBOXHOOKRESPONSE_ANNOTATIONSENTRY._serialized_end=383
  _CONTAINERRESOURCEHOOKREQUEST._serialized_start=1293
  _CONTAINERRESOURCEHOOKREQUEST._serialized_end=1652
  _CONTAINERRESOURCEHOOKREQUEST_ENVENTRY._serialized_start=1610
  _CONTAINERRESOURCEHOOKREQUEST_ENVENTRY._serialized_end=1652
  _CONTAINERRESOURCEHOOKRESPONSE._serialized_start=1655
  _CONTAINERRESOURCEHOOKRESPONSE._serialized_end=2035
  _CONTAINERRESOURCEHOOKRESPONSE_ANNOTATIONSENTRY._serialized_start=333
  _CONTAINERRESOURCEHOOKRESPONSE_ANNOTATIONSENTRY._serialized_end=383
  _CONTAINERRESOURCEHOOKRESPONSE_ENVENTRY._serialized_start=1610
  _CONTAINERRESOURCEHOOKRESPONSE_ENVENTRY._serialized_end=1652
  _RUNTIMEHOOKSERVICE._serialized_start=2038
  _RUNTIMEHOOKSERVICE._serialized_end=3056
# @@protoc_insertion_point(module_scope)

# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: nri.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tnri.proto\x12\x12koordinator.nri.v1\"9\n\x0eRegisterPlugin\x12\x13\n\x0bplugin_name\x18\x01 \x01(\t\x12\x12\n\nplugin_idx\x18\x02 \x01(\t\"Q\n\x10\x43onfigureRequest\x12\x0e\n\x06\x63onfig\x18\x01 \x01(\t\x12\x14\n\x0cruntime_name\x18\x02 \x01(\t\x12\x17\n\x0fruntime_version\x18\x03 \x01(\t\"#\n\x11\x43onfigureResponse\x12\x0e\n\x06\x65vents\x18\x01 \x01(\x03\"\xc2\x02\n\nPodSandbox\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0c\n\x04name\x18\x02 \x01(\t\x12\x11\n\tnamespace\x18\x03 \x01(\t\x12\x0b\n\x03uid\x18\x04 \x01(\t\x12:\n\x06labels\x18\x05 \x03(\x0b\x32*.koordinator.nri.v1.PodSandbox.LabelsEntry\x12\x44\n\x0b\x61nnotations\x18\x06 \x03(\x0b\x32/.koordinator.nri.v1.PodSandbox.AnnotationsEntry\x12\x15\n\rcgroup_parent\x18\x07 \x01(\t\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\xc4\x02\n\tContainer\x12\n\n\x02id\x18\x01 \x01(\t\x12\x16\n\x0epod_sandbox_id\x18\x02 \x01(\t\x12\x0c\n\x04name\x18\x03 \x01(\t\x12\x39\n\x06labels\x18\x04 \x03(\x0b\x32).koordinator.nri.v1.Container.LabelsEntry\x12\x43\n\x0b\x61nnotations\x18\x05 \x03(\x0b\x32..koordinator.nri.v1.Container.AnnotationsEntry\x12\x15\n\rcgroup_parent\x18\x06 \x01(\t\x12\x0b\n\x03\x65nv\x18\x07 \x03(\t\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x94\x01\n\x0eLinuxResources\x12\x13\n\x0b\x63puset_cpus\x18\x01 \x01(\t\x12\x13\n\x0b\x63puset_mems\x18\x02 \x01(\t\x12\x11\n\tcpu_quota\x18\x03 \x01(\x03\x12\x12\n\ncpu_period\x18\x04 \x01(\x03\x12\x12\n\ncpu_shares\x18\x05 \x01(\x03\x12\x1d\n\x15memory_limit_in_bytes\x18\x06 \x01(\x03\"&\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"\xfa\x01\n\x13\x43ontainerAdjustment\x12)\n\x03\x65nv\x18\x01 \x03(\x0b\x32\x1c.koordinator.nri.v1.KeyValue\x12\x35\n\tresources\x18\x02 \x01(\x0b\x32\".koordinator.nri.v1.LinuxResources\x12M\n\x0b\x61nnotations\x18\x03 \x03(\x0b\x32\x38.koordinator.nri.v1.ContainerAdjustment.AnnotationsEntry\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"^\n\x0f\x43ontainerUpdate\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\x12\x35\n\tresources\x18\x02 \x01(\x0b\x32\".koordinator.nri.v1.LinuxResources\"u\n\x12SynchronizeRequest\x12,\n\x04pods\x18\x01 \x03(\x0b\x32\x1e.koordinator.nri.v1.PodSandbox\x12\x31\n\ncontainers\x18\x02 \x03(\x0b\x32\x1d.koordinator.nri.v1.Container\"K\n\x13SynchronizeResponse\x12\x34\n\x07updates\x18\x01 \x03(\x0b\x32#.koordinator.nri.v1.ContainerUpdate\"C\n\x14RunPodSandboxRequest\x12+\n\x03pod\x18\x01 \x01(\x0b\x32\x1e.koordinator.nri.v1.PodSandbox\"w\n\x16\x43reateContainerRequest\x12+\n\x03pod\x18\x01 \x01(\x0b\x32\x1e.koordinator.nri.v1.PodSandbox\x12\x30\n\tcontainer\x18\x02 \x01(\x0b\x32\x1d.koordinator.nri.v1.Container\"\x88\x01\n\x17\x43reateContainerResponse\x12\x37\n\x06\x61\x64just\x18\x01 \x01(\x0b\x32\'.koordinator.nri.v1.ContainerAdjustment\x12\x34\n\x07updates\x18\x02 \x03(\x0b\x32#.koordinator.nri.v1.ContainerUpdate\"w\n\x16UpdateContainerRequest\x12+\n\x03pod\x18\x01 \x01(\x0b\x32\x1e.koordinator.nri.v1.PodSandbox\x12\x30\n\tcontainer\x18\x02 \x01(\x0b\x32\x1d.koordinator.nri.v1.Container\"O\n\x17UpdateContainerResponse\x12\x34\n\x07updates\x18\x01 \x03(\x0b\x32#.koordinator.nri.v1.ContainerUpdate\"\x07\n\x05\x45mpty\"\x18\n\x05\x45rror\x12\x0f\n\x07message\x18\x01 \x01(\tb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'nri_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PODSANDBOX_LABELSENTRY._options = None
  _PODSANDBOX_LABELSENTRY._serialized_options = b'8\001'
  _PODSANDBOX_ANNOTATIONSENTRY._options = None
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINER_LABELSENTRY._options = None
  _CONTAINER_LABELSENTRY._serialized_options = b'8\001'
  _CONTAINER_ANNOTATIONSENTRY._options = None
  _CONTAINER_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._options = None
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _REGISTERPLUGIN._serialized_start=33
  _REGISTERPLUGIN._serialized_end=90
  _CONFIGUREREQUEST._serialized_start=92
  _CONFIGUREREQUEST._serialized_end=173
  _CONFIGURERESPONSE._serialized_start=175
  _CONFIGURERESPONSE._serialized_end=210
  _PODSANDBOX._serialized_start=213
  _PODSANDBOX._serialized_end=535
  _PODSANDBOX_LABELSENTRY._serialized_start=438
  _PODSANDBOX_LABELSENTRY._serialized_end=483
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_start=485
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_end=535
  _CONTAINER._serialized_start=538
  _CONTAINER._serialized_end=862
  _CONTAINER_LABELSENTRY._serialized_start=438
  _CONTAINER_LABELSENTRY._serialized_end=483
  _CONTAINER_ANNOTATIONSENTRY._serialized_start=485
  _CONTAINER_ANNOTATIONSENTRY._serialized_end=535
  _LINUXRESOURCES._serialized_start=865
  _LINUXRESOURCES._serialized_end=1013
  _KEYVALUE._serialized_start=1015
  _KEYVALUE._serialized_end=1053
  _CONTAINERADJUSTMENT._serialized_start=1056
  _CONTAINERADJUSTMENT._serialized_end=1306
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_start=485
  _CONTAINERADJUSTMENT_ANNOTATIONSENTRY._serialized_end=535
  _CONTAINERUPDATE._serialized_start=1308
  _CONTAINERUPDATE._serialized_end=1402
  _SYNCHRONIZEREQUEST._serialized_start=1404
  _SYNCHRONIZEREQUEST._serialized_end=1521
  _SYNCHRONIZERESPONSE._serialized_start=1523
  _SYNCHRONIZERESPONSE._serialized_end=1598
  _RUNPODSANDBOXREQUEST._serialized_start=1600
  _RUNPODSANDBOXREQUEST._serialized_end=1667
  _CREATECONTAINERREQUEST._serialized_start=1669
  _CREATECONTAINERREQUEST._serialized_end=1788
  _CREATECONTAINERRESPONSE._serialized_start=1791
  _CREATECONTAINERRESPONSE._serialized_end=1927
  _UPDATECONTAINERREQUEST._serialized_start=1929
  _UPDATECONTAINERREQUEST._serialized_end=2048
  _UPDATECONTAINERRESPONSE._serialized_start=2050
  _UPDATECONTAINERRESPONSE._serialized_end=2129
  _EMPTY._serialized_start=2131
  _EMPTY._serialized_end=2138
  _ERROR._serialized_start=2140
  _ERROR._serialized_end=2164
# @@protoc_insertion_point(module_scope)

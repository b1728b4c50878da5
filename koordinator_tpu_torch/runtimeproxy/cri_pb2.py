# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: cri.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tcri.proto\x12\nruntime.v1\"!\n\x0eVersionRequest\x12\x0f\n\x07version\x18\x01 \x01(\t\"n\n\x0fVersionResponse\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x14\n\x0cruntime_name\x18\x02 \x01(\t\x12\x17\n\x0fruntime_version\x18\x03 \x01(\t\x12\x1b\n\x13runtime_api_version\x18\x04 \x01(\t\"S\n\x12PodSandboxMetadata\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0b\n\x03uid\x18\x02 \x01(\t\x12\x11\n\tnamespace\x18\x03 \x01(\t\x12\x0f\n\x07\x61ttempt\x18\x04 \x01(\r\".\n\x15LinuxPodSandboxConfig\x12\x15\n\rcgroup_parent\x18\x02 \x01(\t\"\xd7\x02\n\x10PodSandboxConfig\x12\x30\n\x08metadata\x18\x01 \x01(\x0b\x32\x1e.runtime.v1.PodSandboxMetadata\x12\x38\n\x06labels\x18\x04 \x03(\x0b\x32(.runtime.v1.PodSandboxConfig.LabelsEntry\x12\x42\n\x0b\x61nnotations\x18\x05 \x03(\x0b\x32-.runtime.v1.PodSandboxConfig.AnnotationsEntry\x12\x30\n\x05linux\x18\x08 \x01(\x0b\x32!.runtime.v1.LinuxPodSandboxConfig\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"]\n\x14RunPodSandboxRequest\x12,\n\x06\x63onfig\x18\x01 \x01(\x0b\x32\x1c.runtime.v1.PodSandboxConfig\x12\x17\n\x0fruntime_handler\x18\x02 \x01(\t\"/\n\x15RunPodSandboxResponse\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t\"/\n\x15StopPodSandboxRequest\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t\"\x18\n\x16StopPodSandboxResponse\"&\n\x08KeyValue\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t\"\xa7\x02\n\x17LinuxContainerResources\x12\x12\n\ncpu_period\x18\x01 \x01(\x03\x12\x11\n\tcpu_quota\x18\x02 \x01(\x03\x12\x12\n\ncpu_shares\x18\x03 \x01(\x03\x12\x1d\n\x15memory_limit_in_bytes\x18\x04 \x01(\x03\x12\x15\n\room_score_adj\x18\x05 \x01(\x03\x12\x13\n\x0b\x63puset_cpus\x18\x06 \x01(\t\x12\x13\n\x0b\x63puset_mems\x18\x07 \x01(\t\x12\x41\n\x07unified\x18\t \x03(\x0b\x32\x30.runtime.v1.LinuxContainerResources.UnifiedEntry\x1a.\n\x0cUnifiedEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"N\n\x14LinuxContainerConfig\x12\x36\n\tresources\x18\x01 \x01(\x0b\x32#.runtime.v1.LinuxContainerResources\"2\n\x11\x43ontainerMetadata\x12\x0c\n\x04name\x18\x01 \x01(\t\x12\x0f\n\x07\x61ttempt\x18\x02 \x01(\r\"\xf6\x02\n\x0f\x43ontainerConfig\x12/\n\x08metadata\x18\x01 \x01(\x0b\x32\x1d.runtime.v1.ContainerMetadata\x12\"\n\x04\x65nvs\x18\x06 \x03(\x0b\x32\x14.runtime.v1.KeyValue\x12\x37\n\x06labels\x18\t \x03(\x0b\x32\'.runtime.v1.ContainerConfig.LabelsEntry\x12\x41\n\x0b\x61nnotations\x18\n \x03(\x0b\x32,.runtime.v1.ContainerConfig.AnnotationsEntry\x12/\n\x05linux\x18\x0f \x01(\x0b\x32 .runtime.v1.LinuxContainerConfig\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x93\x01\n\x16\x43reateContainerRequest\x12\x16\n\x0epod_sandbox_id\x18\x01 \x01(\t\x12+\n\x06\x63onfig\x18\x02 \x01(\x0b\x32\x1b.runtime.v1.ContainerConfig\x12\x34\n\x0esandbox_config\x18\x03 \x01(\x0b\x32\x1c.runtime.v1.PodSandboxConfig\"/\n\x17\x43reateContainerResponse\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\"-\n\x15StartContainerRequest\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\"\x18\n\x16StartContainerResponse\"=\n\x14StopContainerRequest\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\x12\x0f\n\x07timeout\x18\x02 \x01(\x03\"\x17\n\x15StopContainerResponse\"k\n\x1fUpdateContainerResourcesRequest\x12\x14\n\x0c\x63ontainer_id\x18\x01 \x01(\t\x12\x32\n\x05linux\x18\x02 \x01(\x0b\x32#.runtime.v1.LinuxContainerResources\"\"\n UpdateContainerResourcesResponse\"\x9f\x02\n\nPodSandbox\x12\n\n\x02id\x18\x01 \x01(\t\x12\x30\n\x08metadata\x18\x02 \x01(\x0b\x32\x1e.runtime.v1.PodSandboxMetadata\x12\x32\n\x06labels\x18\x04 \x03(\x0b\x32\".runtime.v1.PodSandbox.LabelsEntry\x12<\n\x0b\x61nnotations\x18\x05 \x03(\x0b\x32\'.runtime.v1.PodSandbox.AnnotationsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x17\n\x15ListPodSandboxRequest\"?\n\x16ListPodSandboxResponse\x12%\n\x05items\x18\x01 \x03(\x0b\x32\x16.runtime.v1.PodSandbox\"\xb3\x02\n\tContainer\x12\n\n\x02id\x18\x01 \x01(\t\x12\x16\n\x0epod_sandbox_id\x18\x02 \x01(\t\x12/\n\x08metadata\x18\x03 \x01(\x0b\x32\x1d.runtime.v1.ContainerMetadata\x12\x31\n\x06labels\x18\x06 \x03(\x0b\x32!.runtime.v1.Container.LabelsEntry\x12;\n\x0b\x61nnotations\x18\x07 \x03(\x0b\x32&.runtime.v1.Container.AnnotationsEntry\x1a-\n\x0bLabelsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x1a\x32\n\x10\x41nnotationsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"\x17\n\x15ListContainersRequest\"C\n\x16ListContainersResponse\x12)\n\ncontainers\x18\x01 \x03(\x0b\x32\x15.runtime.v1.Container2\xb7\x06\n\x0eRuntimeService\x12\x42\n\x07Version\x12\x1a.runtime.v1.VersionRequest\x1a\x1b.runtime.v1.VersionResponse\x12T\n\rRunPodSandbox\x12 .runtime.v1.RunPodSandboxRequest\x1a!.runtime.v1.RunPodSandboxResponse\x12W\n\x0eStopPodSandbox\x12!.runtime.v1.StopPodSandboxRequest\x1a\".runtime.v1.StopPodSandboxResponse\x12Z\n\x0f\x43reateContainer\x12\".runtime.v1.CreateContainerRequest\x1a#.runtime.v1.CreateContainerResponse\x12W\n\x0eStartContainer\x12!.runtime.v1.StartContainerRequest\x1a\".runtime.v1.StartContainerResponse\x12T\n\rStopContainer\x12 .runtime.v1.StopContainerRequest\x1a!.runtime.v1.StopContainerResponse\x12u\n\x18UpdateContainerResources\x12+.runtime.v1.UpdateContainerResourcesRequest\x1a,.runtime.v1.UpdateContainerResourcesResponse\x12W\n\x0eListPodSandbox\x12!.runtime.v1.ListPodSandboxRequest\x1a\".runtime.v1.ListPodSandboxResponse\x12W\n\x0eListContainers\x12!.runtime.v1.ListContainersRequest\x1a\".runtime.v1.ListContainersResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'cri_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _PODSANDBOXCONFIG_LABELSENTRY._options = None
  _PODSANDBOXCONFIG_LABELSENTRY._serialized_options = b'8\001'
  _PODSANDBOXCONFIG_ANNOTATIONSENTRY._options = None
  _PODSANDBOXCONFIG_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _LINUXCONTAINERRESOURCES_UNIFIEDENTRY._options = None
  _LINUXCONTAINERRESOURCES_UNIFIEDENTRY._serialized_options = b'8\001'
  _CONTAINERCONFIG_LABELSENTRY._options = None
  _CONTAINERCONFIG_LABELSENTRY._serialized_options = b'8\001'
  _CONTAINERCONFIG_ANNOTATIONSENTRY._options = None
  _CONTAINERCONFIG_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _PODSANDBOX_LABELSENTRY._options = None
  _PODSANDBOX_LABELSENTRY._serialized_options = b'8\001'
  _PODSANDBOX_ANNOTATIONSENTRY._options = None
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _CONTAINER_LABELSENTRY._options = None
  _CONTAINER_LABELSENTRY._serialized_options = b'8\001'
  _CONTAINER_ANNOTATIONSENTRY._options = None
  _CONTAINER_ANNOTATIONSENTRY._serialized_options = b'8\001'
  _VERSIONREQUEST._serialized_start=25
  _VERSIONREQUEST._serialized_end=58
  _VERSIONRESPONSE._serialized_start=60
  _VERSIONRESPONSE._serialized_end=170
  _PODSANDBOXMETADATA._serialized_start=172
  _PODSANDBOXMETADATA._serialized_end=255
  _LINUXPODSANDBOXCONFIG._serialized_start=257
  _LINUXPODSANDBOXCONFIG._serialized_end=303
  _PODSANDBOXCONFIG._serialized_start=306
  _PODSANDBOXCONFIG._serialized_end=649
  _PODSANDBOXCONFIG_LABELSENTRY._serialized_start=552
  _PODSANDBOXCONFIG_LABELSENTRY._serialized_end=597
  _PODSANDBOXCONFIG_ANNOTATIONSENTRY._serialized_start=599
  _PODSANDBOXCONFIG_ANNOTATIONSENTRY._serialized_end=649
  _RUNPODSANDBOXREQUEST._serialized_start=651
  _RUNPODSANDBOXREQUEST._serialized_end=744
  _RUNPODSANDBOXRESPONSE._serialized_start=746
  _RUNPODSANDBOXRESPONSE._serialized_end=793
  _STOPPODSANDBOXREQUEST._serialized_start=795
  _STOPPODSANDBOXREQUEST._serialized_end=842
  _STOPPODSANDBOXRESPONSE._serialized_start=844
  _STOPPODSANDBOXRESPONSE._serialized_end=868
  _KEYVALUE._serialized_start=870
  _KEYVALUE._serialized_end=908
  _LINUXCONTAINERRESOURCES._serialized_start=911
  _LINUXCONTAINERRESOURCES._serialized_end=1206
  _LINUXCONTAINERRESOURCES_UNIFIEDENTRY._serialized_start=1160
  _LINUXCONTAINERRESOURCES_UNIFIEDENTRY._serialized_end=1206
  _LINUXCONTAINERCONFIG._serialized_start=1208
  _LINUXCONTAINERCONFIG._serialized_end=1286
  _CONTAINERMETADATA._serialized_start=1288
  _CONTAINERMETADATA._serialized_end=1338
  _CONTAINERCONFIG._serialized_start=1341
  _CONTAINERCONFIG._serialized_end=1715
  _CONTAINERCONFIG_LABELSENTRY._serialized_start=552
  _CONTAINERCONFIG_LABELSENTRY._serialized_end=597
  _CONTAINERCONFIG_ANNOTATIONSENTRY._serialized_start=599
  _CONTAINERCONFIG_ANNOTATIONSENTRY._serialized_end=649
  _CREATECONTAINERREQUEST._serialized_start=1718
  _CREATECONTAINERREQUEST._serialized_end=1865
  _CREATECONTAINERRESPONSE._serialized_start=1867
  _CREATECONTAINERRESPONSE._serialized_end=1914
  _STARTCONTAINERREQUEST._serialized_start=1916
  _STARTCONTAINERREQUEST._serialized_end=1961
  _STARTCONTAINERRESPONSE._serialized_start=1963
  _STARTCONTAINERRESPONSE._serialized_end=1987
  _STOPCONTAINERREQUEST._serialized_start=1989
  _STOPCONTAINERREQUEST._serialized_end=2050
  _STOPCONTAINERRESPONSE._serialized_start=2052
  _STOPCONTAINERRESPONSE._serialized_end=2075
  _UPDATECONTAINERRESOURCESREQUEST._serialized_start=2077
  _UPDATECONTAINERRESOURCESREQUEST._serialized_end=2184
  _UPDATECONTAINERRESOURCESRESPONSE._serialized_start=2186
  _UPDATECONTAINERRESOURCESRESPONSE._serialized_end=2220
  _PODSANDBOX._serialized_start=2223
  _PODSANDBOX._serialized_end=2510
  _PODSANDBOX_LABELSENTRY._serialized_start=552
  _PODSANDBOX_LABELSENTRY._serialized_end=597
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_start=599
  _PODSANDBOX_ANNOTATIONSENTRY._serialized_end=649
  _LISTPODSANDBOXREQUEST._serialized_start=2512
  _LISTPODSANDBOXREQUEST._serialized_end=2535
  _LISTPODSANDBOXRESPONSE._serialized_start=2537
  _LISTPODSANDBOXRESPONSE._serialized_end=2600
  _CONTAINER._serialized_start=2603
  _CONTAINER._serialized_end=2910
  _CONTAINER_LABELSENTRY._serialized_start=552
  _CONTAINER_LABELSENTRY._serialized_end=597
  _CONTAINER_ANNOTATIONSENTRY._serialized_start=599
  _CONTAINER_ANNOTATIONSENTRY._serialized_end=649
  _LISTCONTAINERSREQUEST._serialized_start=2912
  _LISTCONTAINERSREQUEST._serialized_end=2935
  _LISTCONTAINERSRESPONSE._serialized_start=2937
  _LISTCONTAINERSRESPONSE._serialized_end=3004
  _RUNTIMESERVICE._serialized_start=3007
  _RUNTIMESERVICE._serialized_end=3830
# @@protoc_insertion_point(module_scope)

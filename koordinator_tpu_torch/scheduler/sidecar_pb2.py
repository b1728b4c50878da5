# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: sidecar.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\rsidecar.proto\x12\x18koordinator.scheduler.v1\"4\n\x06Tensor\x12\r\n\x05shape\x18\x01 \x03(\x03\x12\r\n\x05\x64type\x18\x02 \x01(\t\x12\x0c\n\x04\x64\x61ta\x18\x03 \x01(\x0c\"\xad\x02\n\x14ScheduleBatchRequest\x12J\n\x06inputs\x18\x01 \x03(\x0b\x32:.koordinator.scheduler.v1.ScheduleBatchRequest.InputsEntry\x12\x11\n\tnum_gangs\x18\x02 \x01(\x03\x12\x12\n\nnum_groups\x18\x03 \x01(\x03\x12\"\n\x1ascore_according_prod_usage\x18\x04 \x01(\x08\x12\x13\n\x0b\x61\x63tive_axes\x18\x05 \x03(\x03\x12\x18\n\x10snapshot_version\x18\x06 \x01(\x04\x1aO\n\x0bInputsEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12/\n\x05value\x18\x02 \x01(\x0b\x32 .koordinator.scheduler.v1.Tensor:\x02\x38\x01\"\xe6\x01\n\x15ScheduleBatchResponse\x12\x30\n\x06\x63hosen\x18\x01 \x01(\x0b\x32 .koordinator.scheduler.v1.Tensor\x12\x33\n\trequested\x18\x02 \x01(\x0b\x32 .koordinator.scheduler.v1.Tensor\x12\x34\n\nquota_used\x18\x03 \x01(\x0b\x32 .koordinator.scheduler.v1.Tensor\x12\x18\n\x10snapshot_version\x18\x04 \x01(\x04\x12\x16\n\x0ekernel_seconds\x18\x05 \x01(\x01\x32\x84\x01\n\x10\x42\x61tchedScheduler\x12p\n\rScheduleBatch\x12..koordinator.scheduler.v1.ScheduleBatchRequest\x1a/.koordinator.scheduler.v1.ScheduleBatchResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'sidecar_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SCHEDULEBATCHREQUEST_INPUTSENTRY._options = None
  _SCHEDULEBATCHREQUEST_INPUTSENTRY._serialized_options = b'8\001'
  _TENSOR._serialized_start=43
  _TENSOR._serialized_end=95
  _SCHEDULEBATCHREQUEST._serialized_start=98
  _SCHEDULEBATCHREQUEST._serialized_end=399
  _SCHEDULEBATCHREQUEST_INPUTSENTRY._serialized_start=320
  _SCHEDULEBATCHREQUEST_INPUTSENTRY._serialized_end=399
  _SCHEDULEBATCHRESPONSE._serialized_start=402
  _SCHEDULEBATCHRESPONSE._serialized_end=632
  _BATCHEDSCHEDULER._serialized_start=635
  _BATCHEDSCHEDULER._serialized_end=767
# @@protoc_insertion_point(module_scope)

# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: brpc_tpu_torch/proto/trackme.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\"brpc_tpu_torch/proto/trackme.proto\x12\x0e\x62rpc_tpu_torch\":\n\x0eTrackMeRequest\x12\x13\n\x0brpc_version\x18\x01 \x01(\x05\x12\x13\n\x0bserver_addr\x18\x02 \x01(\t\"n\n\x0fTrackMeResponse\x12\x31\n\x08severity\x18\x01 \x01(\x0e\x32\x1f.brpc_tpu_torch.TrackMeSeverity\x12\x12\n\nerror_text\x18\x02 \x01(\t\x12\x14\n\x0cnew_interval\x18\x03 \x01(\x05*I\n\x0fTrackMeSeverity\x12\x0e\n\nTRACKME_OK\x10\x00\x12\x13\n\x0fTRACKME_WARNING\x10\x01\x12\x11\n\rTRACKME_FATAL\x10\x02\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'brpc_tpu_torch.proto.trackme_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _TRACKMESEVERITY._serialized_start=226
  _TRACKMESEVERITY._serialized_end=299
  _TRACKMEREQUEST._serialized_start=54
  _TRACKMEREQUEST._serialized_end=112
  _TRACKMERESPONSE._serialized_start=114
  _TRACKMERESPONSE._serialized_end=224
# @@protoc_insertion_point(module_scope)

# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: brpc_tpu_torch/proto/rpc_meta.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n#brpc_tpu_torch/proto/rpc_meta.proto\x12\x0e\x62rpc_tpu_torch\"\xe8\x01\n\x07RpcMeta\x12,\n\x07request\x18\x01 \x01(\x0b\x32\x1b.brpc_tpu_torch.RequestMeta\x12.\n\x08response\x18\x02 \x01(\x0b\x32\x1c.brpc_tpu_torch.ResponseMeta\x12\x15\n\rcompress_type\x18\x03 \x01(\x05\x12\x16\n\x0e\x63orrelation_id\x18\x04 \x01(\x04\x12\x17\n\x0f\x61ttachment_size\x18\x05 \x01(\r\x12\x37\n\x0fstream_settings\x18\x06 \x01(\x0b\x32\x1e.brpc_tpu_torch.StreamSettings\"\xe7\x01\n\x0bRequestMeta\x12\x14\n\x0cservice_name\x18\x01 \x01(\t\x12\x13\n\x0bmethod_name\x18\x02 \x01(\t\x12\x0e\n\x06log_id\x18\x03 \x01(\x03\x12\x10\n\x08trace_id\x18\x04 \x01(\x04\x12\x0f\n\x07span_id\x18\x05 \x01(\x04\x12\x16\n\x0eparent_span_id\x18\x06 \x01(\x04\x12\x12\n\ntimeout_ms\x18\x07 \x01(\x03\x12\x12\n\nauth_token\x18\x08 \x01(\t\x12\x10\n\x08priority\x18\t \x01(\r\x12\x0e\n\x06tenant\x18\n \x01(\t\x12\x18\n\x10\x64\x65\x61\x64line_left_ms\x18\x0b \x01(\x03\"N\n\x0cResponseMeta\x12\x12\n\nerror_code\x18\x01 \x01(\x05\x12\x12\n\nerror_text\x18\x02 \x01(\t\x12\x16\n\x0eretry_after_ms\x18\x03 \x01(\x03\"\xc9\x01\n\x0eStreamSettings\x12\x11\n\tstream_id\x18\x01 \x01(\x04\x12\x18\n\x10remote_stream_id\x18\x02 \x01(\x04\x12\x15\n\rneed_feedback\x18\x03 \x01(\x08\x12\x1a\n\x12write_window_bytes\x18\x04 \x01(\x04\x12\x12\n\nframe_type\x18\x05 \x01(\x05\x12\x18\n\x10has_continuation\x18\x06 \x01(\x08\x12\x11\n\tframe_seq\x18\x07 \x01(\x04\x12\x16\n\x0e\x63onsumed_bytes\x18\x08 \x01(\x04\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'brpc_tpu_torch.proto.rpc_meta_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _RPCMETA._serialized_start=56
  _RPCMETA._serialized_end=288
  _REQUESTMETA._serialized_start=291
  _REQUESTMETA._serialized_end=522
  _RESPONSEMETA._serialized_start=524
  _RESPONSEMETA._serialized_end=602
  _STREAMSETTINGS._serialized_start=605
  _STREAMSETTINGS._serialized_end=806
# @@protoc_insertion_point(module_scope)

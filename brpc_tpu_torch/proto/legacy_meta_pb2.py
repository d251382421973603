# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: brpc_tpu_torch/proto/legacy_meta.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n&brpc_tpu_torch/proto/legacy_meta.proto\x12\x15\x62rpc_tpu_torch.legacy\"\xf8\x01\n\x0fHuluRequestMeta\x12\x14\n\x0cservice_name\x18\x01 \x02(\t\x12\x14\n\x0cmethod_index\x18\x02 \x02(\x05\x12\x15\n\rcompress_type\x18\x03 \x01(\x05\x12\x16\n\x0e\x63orrelation_id\x18\x04 \x01(\x03\x12\x0e\n\x06log_id\x18\x05 \x01(\x03\x12\x10\n\x08trace_id\x18\x07 \x01(\x03\x12\x16\n\x0eparent_span_id\x18\x08 \x01(\x03\x12\x0f\n\x07span_id\x18\t \x01(\x03\x12\x11\n\tuser_data\x18\x0b \x01(\x0c\x12\x13\n\x0bmethod_name\x18\x0e \x01(\t\x12\x17\n\x0f\x63redential_data\x18\x0f \x01(\x0c\"|\n\x10HuluResponseMeta\x12\x12\n\nerror_code\x18\x01 \x01(\x05\x12\x12\n\nerror_text\x18\x02 \x01(\t\x12\x16\n\x0e\x63orrelation_id\x18\x03 \x01(\x12\x12\x15\n\rcompress_type\x18\x04 \x01(\x05\x12\x11\n\tuser_data\x18\x07 \x01(\x0c\"\x85\x02\n\x0bSofaRpcMeta\x12\x35\n\x04type\x18\x01 \x02(\x0e\x32\'.brpc_tpu_torch.legacy.SofaRpcMeta.Type\x12\x13\n\x0bsequence_id\x18\x02 \x02(\x04\x12\x0e\n\x06method\x18\x64 \x01(\t\x12\x0f\n\x06\x66\x61iled\x18\xc8\x01 \x01(\x08\x12\x13\n\nerror_code\x18\xc9\x01 \x01(\x05\x12\x0f\n\x06reason\x18\xca\x01 \x01(\t\x12\x16\n\rcompress_type\x18\xac\x02 \x01(\x05\x12(\n\x1f\x65xpected_response_compress_type\x18\xad\x02 \x01(\x05\"!\n\x04Type\x12\x0b\n\x07REQUEST\x10\x00\x12\x0c\n\x08RESPONSE\x10\x01\"\xb5\x01\n\x11PublicRequestHead\x12\x11\n\tfrom_host\x18\x01 \x01(\t\x12\x14\n\x0c\x63ontent_type\x18\x02 \x01(\r\x12\x12\n\nconnection\x18\x03 \x01(\x08\x12\x0f\n\x07\x63harset\x18\x04 \x01(\t\x12\x16\n\x0e\x61\x63\x63\x65pt_charset\x18\x05 \x01(\t\x12\x13\n\x0b\x63reate_time\x18\x06 \x01(\t\x12\x0e\n\x06log_id\x18\x07 \x01(\x04\x12\x15\n\rcompress_type\x18\x08 \x01(\r\"\x81\x01\n\x11PublicRequestBody\x12\x0f\n\x07version\x18\x01 \x01(\t\x12\x0f\n\x07\x63harset\x18\x02 \x01(\t\x12\x0f\n\x07service\x18\x03 \x02(\t\x12\x11\n\tmethod_id\x18\x04 \x02(\r\x12\n\n\x02id\x18\x05 \x02(\x04\x12\x1a\n\x12serialized_request\x18\x06 \x01(\x0c\"\x8d\x01\n\rPublicRequest\x12=\n\x0brequestHead\x18\x01 \x01(\x0b\x32(.brpc_tpu_torch.legacy.PublicRequestHead\x12=\n\x0brequestBody\x18\x02 \x03(\x0b\x32(.brpc_tpu_torch.legacy.PublicRequestBody\"Z\n\x12PublicResponseHead\x12\x0c\n\x04\x63ode\x18\x01 \x02(\x11\x12\x0c\n\x04text\x18\x02 \x01(\t\x12\x11\n\tfrom_host\x18\x03 \x01(\t\x12\x15\n\rcompress_type\x18\x04 \x01(\r\"]\n\x12PublicResponseBody\x12\x1b\n\x13serialized_response\x18\x01 \x01(\x0c\x12\x0f\n\x07version\x18\x02 \x01(\t\x12\r\n\x05\x65rror\x18\x03 \x01(\x05\x12\n\n\x02id\x18\x04 \x02(\x04\"\x92\x01\n\x0ePublicResponse\x12?\n\x0cresponseHead\x18\x01 \x01(\x0b\x32).brpc_tpu_torch.legacy.PublicResponseHead\x12?\n\x0cresponseBody\x18\x02 \x03(\x0b\x32).brpc_tpu_torch.legacy.PublicResponseBody\"\xce\x01\n\nNsheadMeta\x12\x18\n\x10\x66ull_method_name\x18\x01 \x02(\t\x12\x16\n\x0e\x63orrelation_id\x18\x02 \x01(\x03\x12\x0e\n\x06log_id\x18\x03 \x01(\x03\x12\x17\n\x0f\x61ttachment_size\x18\x04 \x01(\x05\x12\x15\n\rcompress_type\x18\x05 \x01(\x05\x12\x10\n\x08trace_id\x18\x06 \x01(\x03\x12\x0f\n\x07span_id\x18\x07 \x01(\x03\x12\x16\n\x0eparent_span_id\x18\x08 \x01(\x03\x12\x13\n\x0buser_string\x18\t \x01(\x0c')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'brpc_tpu_torch.proto.legacy_meta_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _HULUREQUESTMETA._serialized_start=66
  _HULUREQUESTMETA._serialized_end=314
  _HULURESPONSEMETA._serialized_start=316
  _HULURESPONSEMETA._serialized_end=440
  _SOFARPCMETA._serialized_start=443
  _SOFARPCMETA._serialized_end=704
  _SOFARPCMETA_TYPE._serialized_start=671
  _SOFARPCMETA_TYPE._serialized_end=704
  _PUBLICREQUESTHEAD._serialized_start=707
  _PUBLICREQUESTHEAD._serialized_end=888
  _PUBLICREQUESTBODY._serialized_start=891
  _PUBLICREQUESTBODY._serialized_end=1020
  _PUBLICREQUEST._serialized_start=1023
  _PUBLICREQUEST._serialized_end=1164
  _PUBLICRESPONSEHEAD._serialized_start=1166
  _PUBLICRESPONSEHEAD._serialized_end=1256
  _PUBLICRESPONSEBODY._serialized_start=1258
  _PUBLICRESPONSEBODY._serialized_end=1351
  _PUBLICRESPONSE._serialized_start=1354
  _PUBLICRESPONSE._serialized_end=1500
  _NSHEADMETA._serialized_start=1503
  _NSHEADMETA._serialized_end=1709
# @@protoc_insertion_point(module_scope)

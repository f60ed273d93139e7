# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: metricssvc.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x10metricssvc.proto\x12\nmetricssvc\"\x07\n\x05\x45mpty\"\x1b\n\rTPUGetRequest\x12\n\n\x02id\x18\x01 \x03(\t\"S\n\x08TPUState\x12\n\n\x02id\x18\x01 \x01(\t\x12\x0e\n\x06health\x18\x02 \x01(\t\x12\x1b\n\x13\x61ssociated_workload\x18\x03 \x03(\t\x12\x0e\n\x06\x64\x65vice\x18\x04 \x01(\t\";\n\x10TPUStateResponse\x12\'\n\ttpu_state\x18\x01 \x03(\x0b\x32\x14.metricssvc.TPUState2\x95\x01\n\x0eMetricsService\x12H\n\x0bGetTPUState\x12\x19.metricssvc.TPUGetRequest\x1a\x1c.metricssvc.TPUStateResponse\"\x00\x12\x39\n\x04List\x12\x11.metricssvc.Empty\x1a\x1c.metricssvc.TPUStateResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'metricssvc_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _EMPTY._serialized_start=32
  _EMPTY._serialized_end=39
  _TPUGETREQUEST._serialized_start=41
  _TPUGETREQUEST._serialized_end=68
  _TPUSTATE._serialized_start=70
  _TPUSTATE._serialized_end=153
  _TPUSTATERESPONSE._serialized_start=155
  _TPUSTATERESPONSE._serialized_end=214
  _METRICSSERVICE._serialized_start=217
  _METRICSSERVICE._serialized_end=366
# @@protoc_insertion_point(module_scope)

# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: orchestrator.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x12orchestrator.proto\x12\x0bmtt.serving\"6\n\rDecodeRequest\x12\x11\n\ttoken_ids\x18\x01 \x03(\x05\x12\x12\n\nmax_tokens\x18\x02 \x01(\x05\"@\n\x0e\x44\x65\x63odeResponse\x12\x11\n\ttoken_ids\x18\x01 \x03(\x05\x12\x0c\n\x04\x64one\x18\x02 \x01(\x08\x12\r\n\x05\x65rror\x18\x03 \x01(\t\"i\n\x11SynthesizeRequest\x12\x0c\n\x04text\x18\x01 \x01(\t\x12\x16\n\x0eprompt_wav_16k\x18\x02 \x03(\x02\x12\x16\n\x0eprompt_wav_24k\x18\x03 \x03(\x02\x12\x16\n\x0emax_new_tokens\x18\x04 \x01(\x05\"l\n\x12SynthesizeResponse\x12\x11\n\twav_f32le\x18\x01 \x01(\x0c\x12\x13\n\x0bsample_rate\x18\x02 \x01(\x05\x12\x0c\n\x04\x64one\x18\x03 \x01(\x08\x12\r\n\x05\x65rror\x18\x04 \x01(\t\x12\x11\n\tinfo_json\x18\x05 \x01(\t\"\x14\n\x12HealthCheckRequest\"L\n\x13HealthCheckResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x14\n\x0c\x61\x63tive_slots\x18\x02 \x01(\x05\x12\x13\n\x0bqueue_depth\x18\x03 \x01(\x05\x32\xfc\x01\n\x0cOrchestrator\x12\x45\n\x06\x44\x65\x63ode\x12\x1a.mtt.serving.DecodeRequest\x1a\x1b.mtt.serving.DecodeResponse\"\x00\x30\x01\x12Q\n\nSynthesize\x12\x1e.mtt.serving.SynthesizeRequest\x1a\x1f.mtt.serving.SynthesizeResponse\"\x00\x30\x01\x12R\n\x0bHealthCheck\x12\x1f.mtt.serving.HealthCheckRequest\x1a .mtt.serving.HealthCheckResponse\"\x00\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'orchestrator_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _DECODEREQUEST._serialized_start=35
  _DECODEREQUEST._serialized_end=89
  _DECODERESPONSE._serialized_start=91
  _DECODERESPONSE._serialized_end=155
  _SYNTHESIZEREQUEST._serialized_start=157
  _SYNTHESIZEREQUEST._serialized_end=262
  _SYNTHESIZERESPONSE._serialized_start=264
  _SYNTHESIZERESPONSE._serialized_end=372
  _HEALTHCHECKREQUEST._serialized_start=374
  _HEALTHCHECKREQUEST._serialized_end=394
  _HEALTHCHECKRESPONSE._serialized_start=396
  _HEALTHCHECKRESPONSE._serialized_end=472
  _ORCHESTRATOR._serialized_start=475
  _ORCHESTRATOR._serialized_end=727
# @@protoc_insertion_point(module_scope)

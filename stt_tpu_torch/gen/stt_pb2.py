# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: stt.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\tstt.proto\x12\x03stt\"\x8f\x03\n\x0eSessionRequest\x12\x12\n\nsession_id\x18\x01 \x01(\t\x12\x37\n\nattributes\x18\x02 \x03(\x0b\x32#.stt.SessionRequest.AttributesEntry\x12\x1e\n\x08vad_mode\x18\x03 \x01(\x0e\x32\x0c.stt.VADMode\x12\x13\n\x0bvad_silence\x18\x04 \x01(\x01\x12\x15\n\rvad_threshold\x18\x05 \x01(\x01\x12#\n\x16vad_threshold_override\x18\n \x01(\x01H\x00\x88\x01\x01\x12\x15\n\rrequire_token\x18\x06 \x01(\x08\x12\x15\n\rlanguage_code\x18\x07 \x01(\t\x12\x17\n\x04task\x18\x08 \x01(\x0e\x32\t.stt.Task\x12*\n\x0e\x64\x65\x63ode_profile\x18\t \x01(\x0e\x32\x12.stt.DecodeProfile\x1a\x31\n\x0f\x41ttributesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\x42\x19\n\x17_vad_threshold_override\"\xcd\x02\n\x0fSessionResponse\x12\x38\n\nattributes\x18\x01 \x03(\x0b\x32$.stt.SessionResponse.AttributesEntry\x12\x1e\n\x08vad_mode\x18\x02 \x01(\x0e\x32\x0c.stt.VADMode\x12\x13\n\x0bvad_silence\x18\x03 \x01(\x01\x12\x15\n\rvad_threshold\x18\x04 \x01(\x01\x12\r\n\x05token\x18\x05 \x01(\t\x12\x16\n\x0etoken_required\x18\x06 \x01(\x08\x12\x15\n\rlanguage_code\x18\x07 \x01(\t\x12\x17\n\x04task\x18\x08 \x01(\x0e\x32\t.stt.Task\x12*\n\x0e\x64\x65\x63ode_profile\x18\t \x01(\x0e\x32\x12.stt.DecodeProfile\x1a\x31\n\x0f\x41ttributesEntry\x12\x0b\n\x03key\x18\x01 \x01(\t\x12\r\n\x05value\x18\x02 \x01(\t:\x02\x38\x01\"m\n\nAudioChunk\x12\r\n\x05pcm16\x18\x01 \x01(\x0c\x12\x13\n\x0bsample_rate\x18\x02 \x01(\x05\x12\x10\n\x08is_final\x18\x03 \x01(\x08\x12\x12\n\nsession_id\x18\x04 \x01(\t\x12\x15\n\rsession_token\x18\x05 \x01(\t\"\xbc\x01\n\tSTTResult\x12\x0c\n\x04text\x18\x01 \x01(\t\x12\x10\n\x08is_final\x18\x02 \x01(\x08\x12\x11\n\tstart_sec\x18\x03 \x01(\x01\x12\x0f\n\x07\x65nd_sec\x18\x04 \x01(\x01\x12\x15\n\rlanguage_code\x18\x05 \x01(\t\x12\x10\n\x08language\x18\x06 \x01(\t\x12\x13\n\x0bprobability\x18\x07 \x01(\x01\x12\x16\n\x0e\x63ommitted_text\x18\n \x01(\t\x12\x15\n\runstable_text\x18\x0b \x01(\t*-\n\x07VADMode\x12\x10\n\x0cVAD_CONTINUE\x10\x00\x12\x10\n\x0cVAD_AUTO_END\x10\x01*E\n\x04Task\x12\x14\n\x10TASK_UNSPECIFIED\x10\x00\x12\x13\n\x0fTASK_TRANSCRIBE\x10\x01\x12\x12\n\x0eTASK_TRANSLATE\x10\x02*i\n\rDecodeProfile\x12\x1e\n\x1a\x44\x45\x43ODE_PROFILE_UNSPECIFIED\x10\x00\x12\x1b\n\x17\x44\x45\x43ODE_PROFILE_REALTIME\x10\x01\x12\x1b\n\x17\x44\x45\x43ODE_PROFILE_ACCURATE\x10\x02\x32\x83\x01\n\nSTTBackend\x12:\n\rCreateSession\x12\x13.stt.SessionRequest\x1a\x14.stt.SessionResponse\x12\x39\n\x12StreamingRecognize\x12\x0f.stt.AudioChunk\x1a\x0e.stt.STTResult(\x01\x30\x01\x62\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'stt_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _SESSIONREQUEST_ATTRIBUTESENTRY._options = None
  _SESSIONREQUEST_ATTRIBUTESENTRY._serialized_options = b'8\001'
  _SESSIONRESPONSE_ATTRIBUTESENTRY._options = None
  _SESSIONRESPONSE_ATTRIBUTESENTRY._serialized_options = b'8\001'
  _VADMODE._serialized_start=1058
  _VADMODE._serialized_end=1103
  _TASK._serialized_start=1105
  _TASK._serialized_end=1174
  _DECODEPROFILE._serialized_start=1176
  _DECODEPROFILE._serialized_end=1281
  _SESSIONREQUEST._serialized_start=19
  _SESSIONREQUEST._serialized_end=418
  _SESSIONREQUEST_ATTRIBUTESENTRY._serialized_start=342
  _SESSIONREQUEST_ATTRIBUTESENTRY._serialized_end=391
  _SESSIONRESPONSE._serialized_start=421
  _SESSIONRESPONSE._serialized_end=754
  _SESSIONRESPONSE_ATTRIBUTESENTRY._serialized_start=342
  _SESSIONRESPONSE_ATTRIBUTESENTRY._serialized_end=391
  _AUDIOCHUNK._serialized_start=756
  _AUDIOCHUNK._serialized_end=865
  _STTRESULT._serialized_start=868
  _STTRESULT._serialized_end=1056
  _STTBACKEND._serialized_start=1284
  _STTBACKEND._serialized_end=1415
# @@protoc_insertion_point(module_scope)

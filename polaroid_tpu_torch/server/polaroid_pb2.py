# -*- coding: utf-8 -*-
# Generated by the protocol buffer compiler.  DO NOT EDIT!
# source: polaroid.proto
"""Generated protocol buffer code."""
from google.protobuf.internal import builder as _builder
from google.protobuf import descriptor as _descriptor
from google.protobuf import descriptor_pool as _descriptor_pool
from google.protobuf import symbol_database as _symbol_database
# @@protoc_insertion_point(imports)

_sym_db = _symbol_database.Default()




DESCRIPTOR = _descriptor_pool.Default().AddSerializedFile(b'\n\x0epolaroid.proto\x12\x08polaroid\"f\n\x0fReadFileRequest\x12\x0c\n\x04path\x18\x01 \x01(\t\x12\x0e\n\x06\x66ormat\x18\x02 \x01(\t\x12\x0f\n\x07\x63olumns\x18\x03 \x03(\t\x12\x0e\n\x06n_rows\x18\x04 \x01(\x03\x12\x14\n\x0coptions_json\x18\x05 \x01(\t\"G\n\x0eHandleResponse\x12\x0e\n\x06handle\x18\x01 \x01(\t\x12\x10\n\x08num_rows\x18\x02 \x01(\x03\x12\x13\n\x0bschema_json\x18\x03 \x01(\t\"\x1b\n\nSqlRequest\x12\r\n\x05query\x18\x01 \x01(\t\" \n\x0bPlanRequest\x12\x11\n\tplan_json\x18\x01 \x01(\t\"3\n\rExprOpRequest\x12\x0e\n\x06handle\x18\x01 \x01(\t\x12\x12\n\nexprs_json\x18\x02 \x01(\t\"^\n\x0eGroupByRequest\x12\x0e\n\x06handle\x18\x01 \x01(\t\x12\x11\n\tkeys_json\x18\x02 \x01(\t\x12\x11\n\taggs_json\x18\x03 \x01(\t\x12\x16\n\x0emaintain_order\x18\x04 \x01(\x08\"~\n\x0bJoinRequest\x12\x0c\n\x04left\x18\x01 \x01(\t\x12\r\n\x05right\x18\x02 \x01(\t\x12\x0f\n\x07left_on\x18\x03 \x03(\t\x12\x10\n\x08right_on\x18\x04 \x03(\t\x12\x0b\n\x03how\x18\x05 \x01(\t\x12\x0e\n\x06suffix\x18\x06 \x01(\t\x12\x12\n\njoin_nulls\x18\x07 \x01(\x08\"V\n\x0bSortRequest\x12\x0e\n\x06handle\x18\x01 \x01(\t\x12\x0f\n\x07\x62y_json\x18\x02 \x01(\t\x12\x12\n\ndescending\x18\x03 \x03(\x08\x12\x12\n\nnulls_last\x18\x04 \x03(\x08\">\n\x0cSliceRequest\x12\x0e\n\x06handle\x18\x01 \x01(\t\x12\x0e\n\x06offset\x18\x02 \x01(\x03\x12\x0e\n\x06length\x18\x03 \x01(\x03\"U\n\rUniqueRequest\x12\x0e\n\x06handle\x18\x01 \x01(\t\x12\x0e\n\x06subset\x18\x02 \x03(\t\x12\x0c\n\x04keep\x18\x03 \x01(\t\x12\x16\n\x0emaintain_order\x18\x04 \x01(\x08\"5\n\rRenameRequest\x12\x0e\n\x06handle\x18\x01 \x01(\t\x12\x14\n\x0cmapping_json\x18\x02 \x01(\t\"\x1f\n\rHandleRequest\x12\x0e\n\x06handle\x18\x01 \x01(\t\"(\n\nArrowBatch\x12\x0c\n\x04\x64\x61ta\x18\x01 \x01(\x0c\x12\x0c\n\x04last\x18\x02 \x01(\x08\"%\n\x0eSchemaResponse\x12\x13\n\x0bschema_json\x18\x01 \x01(\t\"-\n\x0eStatusResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x0f\n\x07message\x18\x02 \x01(\t\"&\n\x13ListHandlesResponse\x12\x0f\n\x07handles\x18\x01 \x03(\t\"%\n\x10HeartbeatRequest\x12\x11\n\tclient_id\x18\x01 \x01(\t\"O\n\x11HeartbeatResponse\x12\n\n\x02ok\x18\x01 \x01(\x08\x12\x16\n\x0eserver_time_ms\x18\x02 \x01(\x03\x12\x16\n\x0e\x61\x63tive_handles\x18\x03 \x01(\x03\x32\xb8\t\n\x10\x44\x61taFrameService\x12?\n\x08ReadFile\x12\x19.polaroid.ReadFileRequest\x1a\x18.polaroid.HandleResponse\x12\x35\n\x03Sql\x12\x14.polaroid.SqlRequest\x1a\x18.polaroid.HandleResponse\x12>\n\x0b\x45xecutePlan\x12\x15.polaroid.PlanRequest\x1a\x18.polaroid.HandleResponse\x12;\n\x06\x46ilter\x12\x17.polaroid.ExprOpRequest\x1a\x18.polaroid.HandleResponse\x12;\n\x06Select\x12\x17.polaroid.ExprOpRequest\x1a\x18.polaroid.HandleResponse\x12@\n\x0bWithColumns\x12\x17.polaroid.ExprOpRequest\x1a\x18.polaroid.HandleResponse\x12@\n\nGroupByAgg\x12\x18.polaroid.GroupByRequest\x1a\x18.polaroid.HandleResponse\x12\x37\n\x04Join\x12\x15.polaroid.JoinRequest\x1a\x18.polaroid.HandleResponse\x12\x37\n\x04Sort\x12\x15.polaroid.SortRequest\x1a\x18.polaroid.HandleResponse\x12\x39\n\x05Slice\x12\x16.polaroid.SliceRequest\x1a\x18.polaroid.HandleResponse\x12;\n\x06Unique\x12\x17.polaroid.UniqueRequest\x1a\x18.polaroid.HandleResponse\x12;\n\x06Rename\x12\x17.polaroid.RenameRequest\x1a\x18.polaroid.HandleResponse\x12>\n\tGetSchema\x12\x17.polaroid.HandleRequest\x1a\x18.polaroid.SchemaResponse\x12>\n\tCountRows\x12\x17.polaroid.HandleRequest\x1a\x18.polaroid.HandleResponse\x12:\n\x07\x43ollect\x12\x17.polaroid.HandleRequest\x1a\x14.polaroid.ArrowBatch0\x01\x12:\n\x06Upload\x12\x14.polaroid.ArrowBatch\x1a\x18.polaroid.HandleResponse(\x01\x12\x42\n\rReleaseHandle\x12\x17.polaroid.HandleRequest\x1a\x18.polaroid.StatusResponse\x12\x45\n\x0bListHandles\x12\x17.polaroid.HandleRequest\x1a\x1d.polaroid.ListHandlesResponse\x12\x44\n\tHeartbeat\x12\x1a.polaroid.HeartbeatRequest\x1a\x1b.polaroid.HeartbeatResponseb\x06proto3')

_builder.BuildMessageAndEnumDescriptors(DESCRIPTOR, globals())
_builder.BuildTopDescriptorsAndMessages(DESCRIPTOR, 'polaroid_pb2', globals())
if _descriptor._USE_C_DESCRIPTORS == False:

  DESCRIPTOR._options = None
  _READFILEREQUEST._serialized_start=28
  _READFILEREQUEST._serialized_end=130
  _HANDLERESPONSE._serialized_start=132
  _HANDLERESPONSE._serialized_end=203
  _SQLREQUEST._serialized_start=205
  _SQLREQUEST._serialized_end=232
  _PLANREQUEST._serialized_start=234
  _PLANREQUEST._serialized_end=266
  _EXPROPREQUEST._serialized_start=268
  _EXPROPREQUEST._serialized_end=319
  _GROUPBYREQUEST._serialized_start=321
  _GROUPBYREQUEST._serialized_end=415
  _JOINREQUEST._serialized_start=417
  _JOINREQUEST._serialized_end=543
  _SORTREQUEST._serialized_start=545
  _SORTREQUEST._serialized_end=631
  _SLICEREQUEST._serialized_start=633
  _SLICEREQUEST._serialized_end=695
  _UNIQUEREQUEST._serialized_start=697
  _UNIQUEREQUEST._serialized_end=782
  _RENAMEREQUEST._serialized_start=784
  _RENAMEREQUEST._serialized_end=837
  _HANDLEREQUEST._serialized_start=839
  _HANDLEREQUEST._serialized_end=870
  _ARROWBATCH._serialized_start=872
  _ARROWBATCH._serialized_end=912
  _SCHEMARESPONSE._serialized_start=914
  _SCHEMARESPONSE._serialized_end=951
  _STATUSRESPONSE._serialized_start=953
  _STATUSRESPONSE._serialized_end=998
  _LISTHANDLESRESPONSE._serialized_start=1000
  _LISTHANDLESRESPONSE._serialized_end=1038
  _HEARTBEATREQUEST._serialized_start=1040
  _HEARTBEATREQUEST._serialized_end=1077
  _HEARTBEATRESPONSE._serialized_start=1079
  _HEARTBEATRESPONSE._serialized_end=1158
  _DATAFRAMESERVICE._serialized_start=1161
  _DATAFRAMESERVICE._serialized_end=2369
# @@protoc_insertion_point(module_scope)

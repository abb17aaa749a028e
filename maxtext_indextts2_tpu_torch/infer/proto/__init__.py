"""Generated protobuf messages for the gRPC serving surface.

orchestrator_pb2.py is generated from orchestrator.proto by
tools/regen_proto.sh (protoc --python_out; grpcio-tools is unavailable).
"""

"""Generated + hand-written protocol bindings for ``stt.proto``.

``stt_pb2`` is produced by ``tools/gen_proto.sh`` (protoc --python_out);
``stt_pb2_grpc`` is maintained by hand (no grpc_python_plugin in the image).
"""

from . import stt_pb2, stt_pb2_grpc

__all__ = ["stt_pb2", "stt_pb2_grpc"]

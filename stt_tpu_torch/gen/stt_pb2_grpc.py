"""Hand-written gRPC bindings for the ``stt.STTBackend`` service.

The build environment has ``protoc`` but not ``grpc_python_plugin``, so instead
of machine-generated ``*_pb2_grpc.py`` this module provides the same public
surface (``STTBackendStub``, ``STTBackendServicer``,
``add_STTBackendServicer_to_server``) built directly on :mod:`grpc` generic
handlers. Wire behavior is identical to plugin output: same method paths,
serializers, and RPC arities.

Reference surface: brightleeh/whisper-streaming-stt-server
``gen/stt/python/v1/stt_pb2_grpc.py`` (generated), ``proto/stt.proto:11-17``.
"""

from __future__ import annotations

import grpc

from . import stt_pb2

_SERVICE = "stt.STTBackend"
_CREATE_SESSION = f"/{_SERVICE}/CreateSession"
_STREAMING_RECOGNIZE = f"/{_SERVICE}/StreamingRecognize"


class STTBackendStub:
    """Client-side stub; mirrors the grpc_python_plugin-generated stub."""

    def __init__(self, channel: grpc.Channel) -> None:
        self.CreateSession = channel.unary_unary(
            _CREATE_SESSION,
            request_serializer=stt_pb2.SessionRequest.SerializeToString,
            response_deserializer=stt_pb2.SessionResponse.FromString,
        )
        self.StreamingRecognize = channel.stream_stream(
            _STREAMING_RECOGNIZE,
            request_serializer=stt_pb2.AudioChunk.SerializeToString,
            response_deserializer=stt_pb2.STTResult.FromString,
        )


class STTBackendServicer:
    """Service base class; override both methods in the real servicer."""

    def CreateSession(self, request, context):  # noqa: N802 (proto naming)
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")

    def StreamingRecognize(self, request_iterator, context):  # noqa: N802
        context.set_code(grpc.StatusCode.UNIMPLEMENTED)
        context.set_details("Method not implemented!")
        raise NotImplementedError("Method not implemented!")


def add_STTBackendServicer_to_server(servicer, server) -> None:  # noqa: N802
    rpc_method_handlers = {
        "CreateSession": grpc.unary_unary_rpc_method_handler(
            servicer.CreateSession,
            request_deserializer=stt_pb2.SessionRequest.FromString,
            response_serializer=stt_pb2.SessionResponse.SerializeToString,
        ),
        "StreamingRecognize": grpc.stream_stream_rpc_method_handler(
            servicer.StreamingRecognize,
            request_deserializer=stt_pb2.AudioChunk.FromString,
            response_serializer=stt_pb2.STTResult.SerializeToString,
        ),
    }
    generic_handler = grpc.method_handlers_generic_handler(
        _SERVICE, rpc_method_handlers
    )
    server.add_generic_rpc_handlers((generic_handler,))


class STTBackend:
    """Module-level convenience mirroring generated ``*_pb2_grpc`` classes."""

    @staticmethod
    def CreateSession(request, target, **kwargs):  # noqa: N802
        return grpc.experimental.unary_unary(
            request,
            target,
            _CREATE_SESSION,
            stt_pb2.SessionRequest.SerializeToString,
            stt_pb2.SessionResponse.FromString,
            **kwargs,
        )

    @staticmethod
    def StreamingRecognize(request_iterator, target, **kwargs):  # noqa: N802
        return grpc.experimental.stream_stream(
            request_iterator,
            target,
            _STREAMING_RECOGNIZE,
            stt_pb2.AudioChunk.SerializeToString,
            stt_pb2.STTResult.FromString,
            **kwargs,
        )

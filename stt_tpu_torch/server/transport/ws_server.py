"""WebSocket bridge for browser streaming clients.

Own copy of ``stt_tpu/server/transport/ws_server.py`` for the port, which imports nothing of ``stt_tpu``.

Wire-protocol parity with the reference bridge (``stt_server/backend/
transport/ws_server.py:29-521``): endpoint ``/ws/stream``; JSON ``start``
payload -> ``SessionRequest``; ``{"type":"session",...}`` echo; binary
frames = PCM16 audio; ``{"type":"end"}`` finishes; results stream back as
``{"type":"result"|"error"|"done"}`` frames (done carries the trailing
decode-timing metadata). Pre-accept allowlist/rate-limit rejection and
X-Forwarded-For handling behind trusted proxies are kept.

Substrate: the ``websockets`` asyncio server instead of FastAPI/uvicorn
(neither ships in the serving image). The orchestrator still runs on a
worker thread; audio flows asyncio -> ``queue.Queue`` -> sync generator,
and results bounce back with ``loop.call_soon_threadsafe``, exactly the
reference's threading model.
"""

from __future__ import annotations

import asyncio
import ipaddress
import json
import os
import queue
import threading
import uuid
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import grpc

from ...errors import ErrorCode, STTError
from ...gen import stt_pb2
from ...utils.logging import LOGGER
from ...utils.rate_limit import KeyedRateLimiter

_HTTP_RATE_LIMIT_RPS_ENV = "STT_HTTP_RATE_LIMIT_RPS"
_HTTP_RATE_LIMIT_BURST_ENV = "STT_HTTP_RATE_LIMIT_BURST"
_HTTP_ALLOWLIST_ENV = "STT_HTTP_ALLOWLIST"
_HTTP_TRUSTED_PROXIES_ENV = "STT_HTTP_TRUSTED_PROXIES"


# --- start-payload coercion -------------------------------------------
# The WS JSON protocol accepts either raw enum numbers or the human
# spellings the browser clients send; the alias vocabularies below are
# part of the accepted wire protocol (shared with the gRPC CLI clients).
# Coercion is deliberately lenient — unparseable values fall back to the
# field default and the session-manager validation decides what to do.

_BOOL_WORDS = {
    "1": True, "true": True, "yes": True, "on": True,
    "0": False, "false": False, "no": False, "off": False,
}

_PROFILE_ALIASES = {
    "realtime": stt_pb2.DECODE_PROFILE_REALTIME,
    "rt": stt_pb2.DECODE_PROFILE_REALTIME,
    "low": stt_pb2.DECODE_PROFILE_REALTIME,
    "low_latency": stt_pb2.DECODE_PROFILE_REALTIME,
    "accurate": stt_pb2.DECODE_PROFILE_ACCURATE,
    "accuracy": stt_pb2.DECODE_PROFILE_ACCURATE,
    "high": stt_pb2.DECODE_PROFILE_ACCURATE,
}

_TASK_ALIASES = {
    "transcribe": stt_pb2.TASK_TRANSCRIBE,
    "transcription": stt_pb2.TASK_TRANSCRIBE,
    "translate": stt_pb2.TASK_TRANSLATE,
    "translation": stt_pb2.TASK_TRANSLATE,
}

_VAD_MODE_ALIASES = {
    "auto": stt_pb2.VAD_AUTO_END,
    "auto_end": stt_pb2.VAD_AUTO_END,
    "auto-end": stt_pb2.VAD_AUTO_END,
    "end": stt_pb2.VAD_AUTO_END,
}


def _as_bool(value: Any, default: bool = False) -> bool:
    if isinstance(value, bool):
        return value
    if value is None:
        return default
    return _BOOL_WORDS.get(str(value).strip().lower(), default)


def _as_float(value: Any, default: float = 0.0) -> float:
    try:
        return default if value is None else float(value)
    except (TypeError, ValueError):
        return default


def _as_enum(value: Any, aliases: Dict[str, int], default: int) -> int:
    if isinstance(value, int):
        return value
    return aliases.get(str(value or "").strip().lower(), default)


def _as_attributes(raw: Any) -> Dict[str, str]:
    """JSON object -> proto map<string,string>, dropping null keys/values."""
    if not isinstance(raw, dict):
        return {}
    return {
        str(key): str(val)
        for key, val in raw.items()
        if key is not None and val is not None
    }


def _as_metadata(raw: Any) -> List[Tuple[str, str]]:
    """JSON object -> lowercase gRPC-style invocation-metadata pairs."""
    if not isinstance(raw, dict):
        return []
    return [(str(key).lower(), str(val)) for key, val in raw.items() if key and val is not None]


def _peer_for_ws(client_ip: str) -> str:
    """Render a gRPC-style peer string for session-manager logging."""
    if not client_ip:
        return ""
    return f"ipv6:[{client_ip}]:0" if ":" in client_ip else f"ipv4:{client_ip}:0"


class WebSocketAbort(RuntimeError):
    def __init__(self, status: grpc.StatusCode, details: str) -> None:
        super().__init__(details)
        self.status = status
        self.details = details


class WebSocketContext:
    """grpc.ServicerContext stand-in backing the orchestrator over WS.

    Only the surface the session manager / orchestrator actually touch is
    implemented: invocation metadata, peer, liveness, disconnect callbacks,
    trailing metadata, and abort (raised as :class:`WebSocketAbort`).
    """

    # unbounded trailing metadata: results ride the WS JSON `done` frame,
    # not gRPC wire metadata, so word coverage is never byte-capped
    inprocess_trailing = True

    def __init__(self, metadata: List[Tuple[str, str]], peer: str) -> None:
        self._invocation_md = metadata
        self._peer_label = peer
        self._on_close: List[Any] = []
        self._open = True
        self.trailing_metadata = None

    def peer(self) -> str:
        return self._peer_label

    def is_active(self) -> bool:
        return self._open

    def invocation_metadata(self):
        return list(self._invocation_md)

    def set_trailing_metadata(self, metadata):
        self.trailing_metadata = metadata

    def add_callback(self, callback):
        self._on_close.append(callback)
        return True

    def abort(self, code, details):
        raise WebSocketAbort(code, details)

    def close(self) -> None:
        if not self._open:
            return
        self._open = False
        for hook in self._on_close:
            try:
                hook()
            except Exception:
                LOGGER.exception("WebSocket disconnect callback failed")


class WsBridge:
    """Connection-handling core (transport-agnostic for unit tests)."""

    def __init__(
        self,
        runtime,
        ws_rate_limit_rps: Optional[float] = None,
        ws_rate_limit_burst: Optional[float] = None,
        ws_trusted_proxies: Optional[List[str]] = None,
    ) -> None:
        self.runtime = runtime
        if ws_rate_limit_rps is None:
            try:
                ws_rate_limit_rps = float(os.getenv(_HTTP_RATE_LIMIT_RPS_ENV, ""))
            except (TypeError, ValueError):
                ws_rate_limit_rps = 0.0
        if ws_rate_limit_burst is None:
            try:
                ws_rate_limit_burst = float(os.getenv(_HTTP_RATE_LIMIT_BURST_ENV, ""))
            except (TypeError, ValueError):
                ws_rate_limit_burst = max(1.0, ws_rate_limit_rps)
        self._rate_limiter = KeyedRateLimiter(
            ws_rate_limit_rps, ws_rate_limit_burst or 0.0
        )
        self._allowlist: List[Any] = []
        for entry in os.getenv(_HTTP_ALLOWLIST_ENV, "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            try:
                self._allowlist.append(ipaddress.ip_network(entry, strict=False))
            except ValueError:
                LOGGER.warning("invalid WS allowlist entry ignored: %s", entry)
        if ws_trusted_proxies is None:
            proxy_entries = [
                e.strip()
                for e in os.getenv(_HTTP_TRUSTED_PROXIES_ENV, "").split(",")
                if e.strip()
            ]
        else:
            proxy_entries = [e.strip() for e in ws_trusted_proxies if e]
        self._trusted_proxies: List[Any] = []
        self._trusted_proxy_hosts: List[str] = []
        for entry in proxy_entries:
            try:
                self._trusted_proxies.append(ipaddress.ip_network(entry, strict=False))
            except ValueError:
                if any(ch.isalpha() for ch in entry):
                    self._trusted_proxy_hosts.append(entry)
                else:
                    LOGGER.warning("invalid trusted proxy entry ignored: %s", entry)

    def client_ip(self, peer_ip: str, headers) -> str:
        trusted = peer_ip in self._trusted_proxy_hosts
        if not trusted and self._trusted_proxies:
            try:
                addr = ipaddress.ip_address(peer_ip)
                trusted = any(addr in net for net in self._trusted_proxies)
            except ValueError:
                pass
        if not trusted:
            return peer_ip
        forwarded = (headers.get("x-forwarded-for") or "").strip()
        if not forwarded:
            return peer_ip
        return forwarded.split(",")[-1].strip()

    def check_admission(self, client_ip: str) -> None:
        """Raises STTError for blocked/ratelimited clients (pre-accept)."""
        if self._allowlist:
            try:
                addr = ipaddress.ip_address(client_ip)
            except ValueError:
                raise STTError(ErrorCode.HTTP_IP_FORBIDDEN)
            if not any(addr in net for net in self._allowlist):
                raise STTError(ErrorCode.HTTP_IP_FORBIDDEN)
        key = client_ip or "unknown"
        if not self._rate_limiter.allow(key):
            self.runtime.metrics.record_rate_limit_block("http", key)
            raise STTError(ErrorCode.HTTP_RATE_LIMITED)

    @staticmethod
    def build_session_request(payload: Dict[str, Any], session_id: str):
        request = stt_pb2.SessionRequest(
            session_id=session_id,
            attributes=_as_attributes(payload.get("attributes")),
            vad_mode=_as_enum(
                payload.get("vad_mode"), _VAD_MODE_ALIASES, stt_pb2.VAD_CONTINUE
            ),
            vad_silence=_as_float(payload.get("vad_silence"), 0.0),
            vad_threshold=_as_float(payload.get("vad_threshold"), 0.0),
            require_token=_as_bool(payload.get("require_token"), False),
            language_code=str(payload.get("language_code") or ""),
            task=_as_enum(
                payload.get("task"), _TASK_ALIASES, stt_pb2.TASK_UNSPECIFIED
            ),
            decode_profile=_as_enum(
                payload.get("decode_profile"),
                _PROFILE_ALIASES,
                stt_pb2.DECODE_PROFILE_UNSPECIFIED,
            ),
        )
        if "vad_threshold_override" in payload:
            request.vad_threshold_override = _as_float(
                payload.get("vad_threshold_override"), 0.0
            )
        return request

    async def handle_connection(self, websocket) -> None:
        """Drive one WS streaming session end to end."""
        payload = await _read_start_envelope(websocket)
        if payload is None:
            await websocket.close(code=1003)
            return

        session_id = str(payload.get("session_id") or uuid.uuid4().hex)
        sample_rate = int(payload.get("sample_rate") or 16000)
        context = WebSocketContext(
            _as_metadata(payload.get("metadata")),
            _peer_for_ws(_remote_ip(websocket)),
        )

        try:
            response = self.runtime.create_session_handler.handle(
                self.build_session_request(payload, session_id), context
            )
        except WebSocketAbort as exc:
            frame = _error_frame(exc.details)
            frame["code"] = str(exc.details).split()[0]
            await websocket.send(json.dumps(frame))
            await websocket.close(code=4401)
            return

        await websocket.send(json.dumps(_session_frame(session_id, response)))

        pump = _SessionPump(
            self.runtime,
            context,
            session_id=session_id,
            sample_rate=sample_rate,
            session_token=response.token if response.token_required else "",
        )
        pump.start()
        await asyncio.gather(
            self._ingest_audio(websocket, context, pump),
            pump.flush_to(websocket),
        )
        context.close()  # post-drain cleanup (disconnect callbacks already ran if torn down)
        try:
            await websocket.close()
        except Exception:
            pass

    @staticmethod
    async def _ingest_audio(websocket, context, pump: "_SessionPump") -> None:
        """Read the socket until disconnect or an explicit end frame.

        Binary frames are PCM16 audio; text frames are JSON control
        messages (only ``{"type": "end"}`` is meaningful; the rest are
        ignored for forward compatibility).

        A graceful end frame must NOT close the context: the orchestrator
        still has to decode the buffered tail and emit the final result,
        and ``context.close()`` reads as a client disconnect (which
        cancels in-flight work). Only a real socket teardown closes it.
        """
        graceful = False
        try:
            async for message in websocket:
                if isinstance(message, (bytes, bytearray)):
                    if message:
                        pump.feed(bytes(message))
                    continue
                try:
                    control = json.loads(message)
                except (ValueError, TypeError):
                    continue
                if isinstance(control, dict) and control.get("type") == "end":
                    graceful = True
                    break
        except Exception:
            pass  # socket torn down mid-stream: handled as disconnect below
        finally:
            if not graceful:
                context.close()
            pump.finish()


async def _read_start_envelope(websocket) -> Optional[Dict[str, Any]]:
    """First frame must be JSON; accept bare payloads or a start envelope."""
    try:
        first = json.loads(await websocket.recv())
    except Exception:
        return None
    if not isinstance(first, dict):
        return {}
    if first.get("type") == "start":
        return first.get("data") or first
    return first


def _remote_ip(websocket) -> str:
    addr = getattr(websocket, "remote_address", None)
    return addr[0] if addr else ""


def _session_frame(session_id: str, response) -> Dict[str, Any]:
    """Session-echo frame; field set is the WS wire contract."""
    return {
        "type": "session",
        "session_id": session_id,
        "attributes": dict(response.attributes),
        "token": response.token,
        "token_required": response.token_required,
        "vad_mode": int(response.vad_mode),
        "vad_silence": response.vad_silence,
        "vad_threshold": response.vad_threshold,
        "language_code": response.language_code,
        "task": int(response.task),
        "decode_profile": int(response.decode_profile),
    }


def _result_frame(result) -> Dict[str, Any]:
    return {
        "type": "result",
        "is_final": result.is_final,
        "text": result.text,
        "committed_text": result.committed_text,
        "unstable_text": result.unstable_text,
        "start_sec": result.start_sec,
        "end_sec": result.end_sec,
        "language_code": result.language_code,
        "language": result.language,
        "probability": result.probability,
    }


def _error_frame(message: str) -> Dict[str, Any]:
    return {"type": "error", "message": message}


class _SessionPump:
    """Bridges one live WS connection to the synchronous orchestrator.

    The orchestrator is a blocking generator, so it runs on a daemon
    worker thread. Inbound PCM crosses event-loop -> worker through a
    thread-safe queue; outbound frames are rendered to wire-ready JSON
    dicts on the worker and handed back to the loop via
    ``call_soon_threadsafe``. A ``closing`` flag on each outbound event
    (set on the error/done frames) tells the sender when to stop — the
    worker itself decides how the stream ends.
    """

    _EOS = object()  # inbound end-of-stream marker

    def __init__(
        self,
        runtime,
        context: WebSocketContext,
        *,
        session_id: str,
        sample_rate: int,
        session_token: str,
    ) -> None:
        self._runtime = runtime
        self._context = context
        self._session_id = session_id
        self._sample_rate = sample_rate
        self._session_token = session_token
        self._inbound: "queue.Queue[Any]" = queue.Queue()
        self._outbound: "asyncio.Queue[Tuple[Dict[str, Any], bool]]" = asyncio.Queue()
        self._loop = asyncio.get_running_loop()
        self._worker = threading.Thread(target=self._decode_loop, daemon=True)

    # -- event-loop side --------------------------------------------------

    def start(self) -> None:
        self._worker.start()

    def feed(self, pcm: bytes) -> None:
        self._inbound.put(pcm)

    def finish(self) -> None:
        self._inbound.put(self._EOS)

    async def flush_to(self, websocket) -> None:
        """Forward outbound frames until a closing frame or a dead socket."""
        closing = False
        while not closing:
            frame, closing = await self._outbound.get()
            try:
                await websocket.send(json.dumps(frame))
            except Exception:
                return

    # -- worker-thread side -----------------------------------------------

    def _chunks(self):
        """Sync AudioChunk generator the orchestrator consumes."""
        while True:
            item = self._inbound.get()
            chunk = stt_pb2.AudioChunk(
                session_id=self._session_id,
                sample_rate=self._sample_rate,
                is_final=item is self._EOS,
                session_token=self._session_token,
            )
            if item is not self._EOS:
                chunk.pcm16 = item
            yield chunk
            if chunk.is_final:
                return

    def _emit(self, frame: Dict[str, Any], closing: bool) -> None:
        self._loop.call_soon_threadsafe(self._outbound.put_nowait, (frame, closing))

    def _decode_loop(self) -> None:
        orchestrator = self._runtime.stream_orchestrator
        try:
            for result in orchestrator.run(self._chunks(), self._context):
                self._emit(_result_frame(result), closing=False)
        except Exception as exc:
            message = exc.details if isinstance(exc, WebSocketAbort) else str(exc)
            self._emit(_error_frame(message), closing=True)
        else:
            trailing = self._context.trailing_metadata
            self._emit(
                {"type": "done", "trailing": dict(trailing) if trailing else None},
                closing=True,
            )


@dataclass
class WebSocketServerHandle:
    thread: threading.Thread
    loop: asyncio.AbstractEventLoop
    stop_event: "asyncio.Event"

    def stop(self, timeout: Optional[float] = None) -> None:
        if self.thread.is_alive():
            try:
                self.loop.call_soon_threadsafe(self.stop_event.set)
            except RuntimeError:
                pass
            self.thread.join(timeout=timeout)


def start_ws_server(
    runtime,
    host: str,
    port: int,
    ws_rate_limit_rps: Optional[float] = None,
    ws_rate_limit_burst: Optional[float] = None,
    ws_trusted_proxies: Optional[List[str]] = None,
) -> WebSocketServerHandle:
    """Start the WS bridge on a daemon thread running its own event loop."""
    import websockets
    from websockets.http11 import Response
    from websockets.datastructures import Headers

    bridge = WsBridge(
        runtime,
        ws_rate_limit_rps=ws_rate_limit_rps,
        ws_rate_limit_burst=ws_rate_limit_burst,
        ws_trusted_proxies=ws_trusted_proxies,
    )

    loop = asyncio.new_event_loop()
    stop_event: "asyncio.Event" = None  # created inside the loop
    started = threading.Event()
    holder: Dict[str, Any] = {}

    def _process_request(connection, request):
        # reject before the websocket handshake completes
        if request.path != "/ws/stream":
            return Response(404, "Not Found", Headers(), b"not found\n")
        peer_ip = (
            connection.remote_address[0]
            if getattr(connection, "remote_address", None)
            else ""
        )
        client_ip = bridge.client_ip(peer_ip, request.headers)
        try:
            bridge.check_admission(client_ip)
        except STTError as exc:
            return Response(
                exc.http_status, "Forbidden", Headers(),
                (exc.detail + "\n").encode(),
            )
        return None

    async def _serve() -> None:
        nonlocal stop_event
        stop_event = asyncio.Event()
        holder["stop_event"] = stop_event
        async with websockets.serve(
            bridge.handle_connection,
            host,
            port,
            process_request=_process_request,
            max_size=16 * 1024 * 1024,
        ):
            started.set()
            await stop_event.wait()

    def _run() -> None:
        asyncio.set_event_loop(loop)
        try:
            loop.run_until_complete(_serve())
        except Exception:
            LOGGER.exception("WS server crashed")
            started.set()
        finally:
            loop.close()

    thread = threading.Thread(target=_run, daemon=True)
    thread.start()
    started.wait(timeout=10.0)
    LOGGER.info("WS bridge listening on %s:%d", host, port)
    return WebSocketServerHandle(
        thread=thread, loop=loop, stop_event=holder.get("stop_event")
    )


__all__ = [
    "WebSocketAbort",
    "WebSocketContext",
    "WebSocketServerHandle",
    "WsBridge",
    "start_ws_server",
]

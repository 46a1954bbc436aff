"""The port's WebSocket bridge held to the JAX package's.

Every case of ``tests/test_ws_server.py`` runs on both packages'
``WsBridge`` (``stt_tpu`` and its copy in ``stt_tpu_torch``), each over its
own ``ApplicationRuntime`` on the fake backend, driven through
``WsBridge.handle_connection`` with a fake websocket. Side by side, the
two bridges build the same ``SessionRequest`` bytes from the same start
payloads and send the same frame kinds for the same session. The bridge
imports ``websockets`` only to serve a socket, so the cases skip only
where it is absent.
"""

import asyncio
import importlib
import json

import numpy as np
import pytest

pytest.importorskip("websockets")

PACKAGES = ("stt_tpu", "stt_tpu_torch")


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _make_runtime(pkg):
    cfg = _mod(pkg, "config.loader").ServerConfig(
        model="tiny", model_backend="fake", device="cpu",
        adaptive_throttle_enabled=False, vad_silence=0.4,
    )
    return _mod(pkg, "server.runtime.runtime").ApplicationRuntime(cfg)


@pytest.fixture(scope="module", params=PACKAGES)
def pkg(request):
    return request.param


@pytest.fixture(scope="module")
def runtime(pkg):
    rt = _make_runtime(pkg)
    yield rt
    rt.shutdown(drain_timeout_sec=2.0)


def _bridge(pkg):
    return _mod(pkg, "server.transport.ws_server").WsBridge


START_PAYLOAD = {
    "session_id": "s1",
    "vad_mode": "auto",
    "vad_silence": "0.7",
    "vad_threshold": 0.3,
    "require_token": "true",
    "language_code": "ko",
    "task": "translate",
    "decode_profile": "accurate",
    "attributes": {"api_key": "k", "n": 1},
}


def test_session_request_parsing(pkg):
    pb = _mod(pkg, "gen.stt_pb2")
    bridge = _bridge(pkg)
    req = bridge.build_session_request(START_PAYLOAD, "s1")
    assert req.session_id == "s1"
    assert req.vad_mode == pb.VAD_AUTO_END
    assert abs(req.vad_silence - 0.7) < 1e-6
    assert req.require_token is True
    assert req.language_code == "ko"
    assert req.task == pb.TASK_TRANSLATE
    assert req.decode_profile == pb.DECODE_PROFILE_ACCURATE
    assert dict(req.attributes) == {"api_key": "k", "n": "1"}
    assert not req.HasField("vad_threshold_override")
    req2 = bridge.build_session_request({"vad_threshold_override": 0.0}, "s2")
    assert req2.HasField("vad_threshold_override")


def test_admission_allowlist(runtime, pkg, monkeypatch):
    monkeypatch.setenv("STT_HTTP_ALLOWLIST", "10.0.0.0/8")
    bridge = _bridge(pkg)(runtime)
    with pytest.raises(_mod(pkg, "errors").STTError):
        bridge.check_admission("1.2.3.4")
    bridge.check_admission("10.0.0.5")


def test_admission_rate_limit(runtime, pkg):
    bridge = _bridge(pkg)(runtime, ws_rate_limit_rps=1.0, ws_rate_limit_burst=1.0)
    bridge.check_admission("9.9.9.9")
    with pytest.raises(_mod(pkg, "errors").STTError):
        bridge.check_admission("9.9.9.9")


def test_forwarded_ip_requires_trusted_proxy(runtime, pkg):
    bridge = _bridge(pkg)(runtime, ws_trusted_proxies=["172.16.0.0/12"])
    assert bridge.client_ip("1.1.1.1", {"x-forwarded-for": "8.8.8.8"}) == "1.1.1.1"
    assert bridge.client_ip("172.16.0.9", {"x-forwarded-for": "8.8.8.8"}) == "8.8.8.8"


class FakeWebSocket:
    """Minimal async websocket double: scripted inbound, captured outbound."""

    def __init__(self, inbound):
        self._inbound = list(inbound)
        self.sent = []
        self.closed = None
        self.remote_address = ("1.2.3.4", 1234)

    async def recv(self):
        if not self._inbound:
            raise ConnectionError("closed")
        return self._inbound.pop(0)

    def __aiter__(self):
        return self

    async def __anext__(self):
        # pace frames so the orchestrator thread can decode and emit between
        # chunks (a real client is paced by capture time)
        await asyncio.sleep(0.02)
        if not self._inbound:
            raise StopAsyncIteration
        return self._inbound.pop(0)

    async def send(self, data):
        self.sent.append(data)

    async def close(self, code=1000):
        self.closed = code


def _pcm(seconds: float) -> bytes:
    t = np.arange(int(16000 * seconds)) / 16000
    return (0.3 * np.sin(2 * np.pi * 220 * t) * 32767).astype(np.int16).tobytes()


def _full_session(runtime, pkg, sid):
    start = json.dumps({"type": "start", "session_id": sid, "sample_rate": 16000,
                        "attributes": {"partial": "true"}, "vad_silence": 0.4})
    # 1 s tone, then 1 s silence (trips the VAD), then end
    frames = [_pcm(0.1) for _ in range(10)]
    frames += [b"\x00\x00" * 1600 for _ in range(10)]
    ws = FakeWebSocket([start] + frames + [json.dumps({"type": "end"})])
    asyncio.run(_bridge(pkg)(runtime).handle_connection(ws))
    return [json.loads(m) for m in ws.sent]


def test_full_ws_session(runtime, pkg):
    messages = _full_session(runtime, pkg, f"ws-unit-1-{pkg}")
    kinds = [m["type"] for m in messages]
    assert kinds[0] == "session"
    assert messages[0]["session_id"] == f"ws-unit-1-{pkg}"
    assert "result" in kinds
    assert kinds[-1] == "done"
    result = next(m for m in messages if m["type"] == "result")
    assert result["text"]
    assert "committed_text" in result


def _make_info(pkg):
    pb = _mod(pkg, "gen.stt_pb2")
    info_cls = _mod(pkg, "server.application.session_manager").SessionInfo
    return info_cls(
        attributes={}, vad_mode=pb.VAD_CONTINUE, vad_silence=0.8,
        vad_threshold=0.5, token="", token_required=False,
        client_ip="1.2.3.4", api_key="", decode_profile="realtime",
        decode_options={}, language_code="", task="transcribe",
        model_id="default", vad_reserved=False,
    )


def test_ws_session_create_error(runtime, pkg):
    start = json.dumps({"type": "start", "session_id": "ws-dup", "sample_rate": 16000})
    ws1 = FakeWebSocket([start, json.dumps({"type": "end"})])
    bridge = _bridge(pkg)(runtime)
    asyncio.run(bridge.handle_connection(ws1))
    # a concurrent duplicate, made directly in the session registry
    runtime.session_registry.create_session("ws-dup2", _make_info(pkg))
    ws2 = FakeWebSocket([json.dumps({"type": "start", "session_id": "ws-dup2"})])
    asyncio.run(bridge.handle_connection(ws2))
    messages = [json.loads(m) for m in ws2.sent]
    assert messages and messages[0]["type"] == "error"
    assert messages[0]["code"] == "ERR1002"
    assert ws2.closed == 4401


def test_ws_graceful_end_yields_final(runtime, pkg):
    """A graceful {"type":"end"} drains a final result rather than
    cancelling the session."""
    start = json.dumps({"type": "start", "session_id": "ws-graceful-1",
                        "sample_rate": 16000, "vad_threshold": 0.0,
                        "attributes": {"upload_mode": "batch"}})
    frames = [_pcm(0.25) for _ in range(8)]
    ws = FakeWebSocket([start] + frames + [json.dumps({"type": "end"})])
    asyncio.run(_bridge(pkg)(runtime).handle_connection(ws))
    messages = [json.loads(m) for m in ws.sent]
    finals = [m for m in messages if m["type"] == "result" and m["is_final"]]
    assert finals, f"no final result frame; got kinds {[m['type'] for m in messages]}"
    assert finals[-1]["text"]
    assert messages[-1]["type"] == "done"


def test_ws_invalid_start_closes_1003(runtime, pkg):
    ws = FakeWebSocket(["not json {{{"])
    asyncio.run(_bridge(pkg)(runtime).handle_connection(ws))
    assert ws.closed == 1003
    assert ws.sent == []


# -- side by side --------------------------------------------------------------


@pytest.mark.parametrize("payload", [
    START_PAYLOAD,
    {"vad_threshold_override": 0.0},
    {"vad_mode": "continue", "task": "transcribe", "decode_profile": "realtime"},
    {},
], ids=["full", "override", "realtime", "empty"])
def test_session_request_bytes_match_the_jax_bridge(payload):
    got = {p: _bridge(p).build_session_request(payload, "sid").SerializeToString(
        deterministic=True) for p in PACKAGES}
    assert got["stt_tpu_torch"] == got["stt_tpu"]


def test_frame_kinds_match_the_jax_bridge():
    """The same session on both bridges (fake backend): the same first and
    last frame kinds, the same kinds in between and the same keys in each
    kind of frame (how many partials arrive depends on timing)."""
    rts = {p: _make_runtime(p) for p in PACKAGES}
    try:
        got = {p: _full_session(rt, p, "ws-side") for p, rt in rts.items()}
    finally:
        for rt in rts.values():
            rt.shutdown(drain_timeout_sec=2.0)

    def shape(messages):
        keys = {(m["type"], tuple(sorted(m))) for m in messages}
        return messages[0]["type"], messages[-1]["type"], sorted(keys)

    assert shape(got["stt_tpu_torch"]) == shape(got["stt_tpu"])

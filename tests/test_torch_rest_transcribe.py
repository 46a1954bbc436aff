"""The port's REST transcription endpoint held to the JAX package's.

Every case of ``tests/test_rest_transcribe.py`` runs on both packages'
``rest_transcribe`` and ``HttpPlane`` (``stt_tpu`` and its copies in
``stt_tpu_torch``), each over its own ``ApplicationRuntime`` on the fake
backend: ``POST /v1/audio/transcriptions`` through ``HttpPlane.handle()``,
the full session gauntlet, orchestrator and decode path, no sockets. Decode
semantics mirror the gRPC batch client (the reference's
``stt_client/batch/file.py:271-292``). Side by side, the parsers give the
same results on the same bytes, and the two planes the same answers.

``test_rest_end_to_end_matches_the_jax_server`` runs both servers as
subprocesses on the ``test`` model (float32, seed 0, ``--language en``),
posts the same WAV to each with ``decode_profile=realtime`` and requires the
same text and segments; then one request that names no profile
(``accurate``: beam 5, given ``word_timestamps`` by the test's model
config) with ``timestamp_granularities`` word and segment, whose text,
segments and words must be the JAX server's; then the port serves a
realtime request again.
"""

import contextlib
import importlib
import io
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
import urllib.error
import urllib.request
import wave
from pathlib import Path

import numpy as np
import pytest

PACKAGES = ("stt_tpu", "stt_tpu_torch")
REPO = Path(__file__).resolve().parents[1]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _rest(pkg):
    return _mod(pkg, "server.transport.rest_transcribe")


def _http(pkg):
    return _mod(pkg, "server.transport.http_server")


def _make_runtime(pkg):
    cfg = _mod(pkg, "config.loader").ServerConfig(
        model="tiny", model_backend="fake", device="cpu",
        adaptive_throttle_enabled=False,
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


@pytest.fixture(scope="module")
def plane(runtime, pkg):
    return _http(pkg).HttpPlane(runtime, {"grpc_running": True})


def wav_bytes(seconds=1.0, sr=16000, channels=1, freq=220.0):
    t = np.arange(int(sr * seconds)) / sr
    pcm = (0.3 * np.sin(2 * np.pi * freq * t) * 32767).astype(np.int16)
    if channels == 2:
        inter = np.empty(len(pcm) * 2, np.int16)
        inter[0::2] = pcm
        inter[1::2] = -pcm
        pcm = inter
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(2)
        wf.setframerate(sr)
        wf.writeframes(pcm.tobytes())
    return buf.getvalue()


_PEER_COUNTER = iter(range(1, 250))


def post(plane, body, *, query=None, headers=None, path="/v1/audio/transcriptions"):
    # distinct peer per call: the endpoint rides the real per-IP
    # stream-byte-rate gauntlet, which a shared test IP would trip
    peer = f"9.8.7.{next(_PEER_COUNTER)}"
    return plane.handle(
        "POST", path, query or {}, headers or {}, body, peer
    )


def multipart_body(file_bytes, fields):
    boundary = "xxBOUNDARYxx"
    parts = []
    for name, value in fields.items():
        parts.append(
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="{name}"\r\n\r\n'
            f"{value}\r\n".encode()
        )
    parts.append(
        (
            f"--{boundary}\r\n"
            f'Content-Disposition: form-data; name="file"; '
            f'filename="a.wav"\r\n'
            f"Content-Type: audio/wav\r\n\r\n"
        ).encode()
        + file_bytes
        + b"\r\n"
    )
    parts.append(f"--{boundary}--\r\n".encode())
    return b"".join(parts), f"multipart/form-data; boundary={boundary}"


# -- WAV / multipart parsing ------------------------------------------------


def test_parse_wav_mono(pkg):
    pcm, sr = _rest(pkg).parse_wav_bytes(wav_bytes(seconds=0.5))
    assert sr == 16000 and len(pcm) == 16000  # 0.5s * 16k * 2 bytes


def test_parse_wav_stereo_takes_left(pkg):
    mono_pcm, _ = _rest(pkg).parse_wav_bytes(wav_bytes(seconds=0.1))
    stereo_pcm, _ = _rest(pkg).parse_wav_bytes(wav_bytes(seconds=0.1, channels=2))
    assert stereo_pcm == mono_pcm


def test_parse_wav_rejects_garbage(pkg):
    with pytest.raises(ValueError):
        _rest(pkg).parse_wav_bytes(b"definitely not a wav")


def test_parse_multipart_roundtrip(pkg):
    body, ctype = multipart_body(b"\x00\x01\xff\xfe", {"language": "en"})
    fields, file_bytes = _rest(pkg).parse_multipart(ctype, body)
    assert fields == {"language": "en"}
    assert file_bytes == b"\x00\x01\xff\xfe"


# -- endpoint: happy paths --------------------------------------------------


def test_raw_wav_json_response(plane):
    status, ctype, payload = post(
        plane, wav_bytes(), headers={"content-type": "audio/wav"}
    )
    assert status == 200, payload
    assert ctype == "application/json"
    assert payload["text"].strip()  # fake backend emits deterministic words


def test_multipart_verbose_json(plane):
    body, ctype = multipart_body(
        wav_bytes(seconds=2.0), {"response_format": "verbose_json"}
    )
    status, rtype, payload = post(
        plane, body, headers={"content-type": ctype}
    )
    assert status == 200, payload
    assert payload["duration"] == pytest.approx(2.0)
    assert payload["segments"], payload
    seg = payload["segments"][0]
    assert set(seg) == {"id", "start", "end", "text"}
    assert payload["text"].strip()


def test_text_format(plane):
    status, ctype, payload = post(
        plane, wav_bytes(), query={"response_format": ["text"]}
    )
    assert status == 200
    assert ctype.startswith("text/plain")
    assert isinstance(payload, str) and payload.endswith("\n")


def test_srt_and_vtt_formats(plane):
    status, _, srt = post(
        plane, wav_bytes(), query={"response_format": ["srt"]}
    )
    assert status == 200 and srt.startswith("1\n00:00:00,000 --> ")
    status, ctype, vtt = post(
        plane, wav_bytes(), query={"response_format": ["vtt"]}
    )
    assert status == 200 and vtt.startswith("WEBVTT\n")
    assert ctype.startswith("text/vtt")


# -- endpoint: error paths --------------------------------------------------


def test_empty_body_rejected(plane):
    status, _, payload = post(plane, b"")
    assert status == 400 and payload["code"] == "invalid_request"


def test_non_wav_body_rejected(plane):
    status, _, payload = post(plane, b"\x00" * 64)
    assert status == 400 and "WAV" in payload["message"]


def test_bad_response_format_rejected(plane):
    status, _, payload = post(
        plane, wav_bytes(), query={"response_format": ["yaml"]}
    )
    assert status == 400 and "response_format" in payload["message"]


def test_bad_task_rejected(plane):
    status, _, payload = post(plane, wav_bytes(), query={"task": ["summon"]})
    assert status == 400


def test_unknown_model_id_falls_back_to_default(plane):
    # registry semantics: unknown model_id logs and serves via 'default'
    status, _, payload = post(
        plane, wav_bytes(), query={"model_id": ["nope"]}
    )
    assert status == 200 and payload["text"].strip()


def test_abort_maps_err_code_to_http_status(plane):
    # same peer posting repeatedly trips the per-IP stream byte-rate
    # gauntlet (batch lane) -> ERR-coded JSON with its HTTP status
    statuses = []
    for _ in range(6):
        status, _, payload = plane.handle(
            "POST", "/v1/audio/transcriptions", {}, {},
            wav_bytes(seconds=2.0), "9.8.250.1",
        )
        statuses.append((status, payload))
    errored = [(s, p) for s, p in statuses if s != 200]
    assert errored, "rate gauntlet never tripped"
    status, payload = errored[0]
    assert status == 429
    assert payload["code"].startswith("ERR"), payload


def test_multipart_without_file_rejected(plane):
    body, ctype = multipart_body(b"x", {"language": "en"})
    body = body.replace(b'name="file"', b'name="nope"')
    status, _, payload = post(plane, body, headers={"content-type": ctype})
    assert status == 400 and "file" in payload["message"]


def test_disabled_via_env(plane, monkeypatch):
    monkeypatch.setenv("STT_REST_TRANSCRIBE", "0")
    status, _, _ = post(plane, wav_bytes())
    assert status == 404


# -- POST /v1/audio/translations (task=translate alias) -----------------------


def test_translations_alias_forces_translate(plane):
    body, ctype = multipart_body(
        wav_bytes(), {"response_format": "verbose_json"}
    )
    status, _, payload = post(
        plane, body, headers={"content-type": ctype},
        path="/v1/audio/translations",
    )
    assert status == 200, payload
    assert payload["task"] == "translate"
    assert payload["text"].strip()


def test_translations_alias_accepts_matching_task_field(plane):
    status, _, payload = post(
        plane, wav_bytes(), query={"task": ["translate"]},
        path="/v1/audio/translations",
    )
    assert status == 200 and payload["text"].strip()


def test_translations_alias_rejects_conflicting_task(plane):
    status, _, payload = post(
        plane, wav_bytes(), query={"task": ["transcribe"]},
        path="/v1/audio/translations",
    )
    assert status == 400
    assert "transcriptions" in payload["message"]


def test_translations_disabled_via_env(plane, monkeypatch):
    monkeypatch.setenv("STT_REST_TRANSCRIBE", "no")
    status, _, _ = post(
        plane, wav_bytes(), path="/v1/audio/translations"
    )
    assert status == 404


def test_json_payload_serializable(plane):
    status, _, payload = post(
        plane, wav_bytes(), query={"response_format": ["verbose_json"]}
    )
    assert status == 200
    json.dumps(payload)  # the HTTP layer json-encodes dict payloads


# -- word timestamps in verbose_json ------------------------------------------


def test_words_from_trailing_parses_and_tolerates_garbage(pkg):
    words_from_trailing = _rest(pkg).words_from_trailing
    meta = (
        ("stt-decode-count", "3"),
        ("stt-word-timestamps", '[[0.0,0.42,"hi"],[0.42,1.0,"there"]]'),
    )
    assert words_from_trailing(meta) == [
        {"word": "hi", "start": 0.0, "end": 0.42},
        {"word": "there", "start": 0.42, "end": 1.0},
    ]
    assert words_from_trailing(None) == []
    assert words_from_trailing((("stt-word-timestamps", "not json"),)) == []
    assert words_from_trailing((("other", "x"),)) == []


def test_verbose_json_includes_words_when_profile_emits_them(pkg):
    # stub runtime: the orchestrator sets the same trailing metadata the
    # real _finalize_stream emits when word_timestamps is enabled
    import types

    class _Handler:
        def handle(self, request, context):
            return types.SimpleNamespace(token="", token_required=False)

    class _Orchestrator:
        def run(self, chunks, context):
            list(chunks)
            context.set_trailing_metadata((
                ("stt-word-timestamps", '[[0.0,0.5,"zu"],[0.5,1.0,"zo"]]'),
            ))
            yield types.SimpleNamespace(
                is_final=True, text=" zu zo", start_sec=0.0, end_sec=1.0,
                language_code="en",
            )

    runtime = types.SimpleNamespace(
        create_session_handler=_Handler(), stream_orchestrator=_Orchestrator()
    )
    status, ctype, payload = _rest(pkg).handle_transcription(
        runtime, {"response_format": ["verbose_json"]}, {}, wav_bytes(),
        "9.8.252.1", "",
    )
    assert status == 200, payload
    assert payload["words"] == [
        {"word": "zu", "start": 0.0, "end": 0.5},
        {"word": "zo", "start": 0.5, "end": 1.0},
    ]


def test_verbose_json_omits_words_without_metadata(plane):
    # the fake backend does not emit word timings -> no "words" key
    status, _, payload = post(
        plane, wav_bytes(), query={"response_format": ["verbose_json"]}
    )
    assert status == 200 and "words" not in payload


# -- timestamp_granularities ---------------------------------------------------


def test_granularities_word_only_omits_segments(plane):
    # "word" requested but the fake backend's profile emits no word
    # timings -> OpenAI shape: empty words list, segments omitted
    status, _, payload = post(
        plane, wav_bytes(),
        query={
            "response_format": ["verbose_json"],
            "timestamp_granularities[]": ["word"],
        },
    )
    assert status == 200, payload
    assert payload["words"] == []
    assert "segments" not in payload
    assert payload["text"].strip()


def test_granularities_segment_only_omits_words(plane):
    status, _, payload = post(
        plane, wav_bytes(),
        query={
            "response_format": ["verbose_json"],
            "timestamp_granularities": ["segment"],
        },
    )
    assert status == 200 and payload["segments"]
    assert "words" not in payload


def test_granularities_invalid_rejected(plane):
    status, _, payload = post(
        plane, wav_bytes(), query={"timestamp_granularities[]": ["sentence"]}
    )
    assert status == 400
    assert "timestamp_granularities" in payload["message"]


def test_granularities_multipart_repeated_parts(pkg):
    # OpenAI sends one `timestamp_granularities[]` part per value; the
    # multipart parser comma-joins repeats and the parser splits them
    body, ctype = multipart_body(
        b"x",
        {"response_format": "verbose_json"},
    )
    extra = (
        b"--xxBOUNDARYxx\r\n"
        b'Content-Disposition: form-data; '
        b'name="timestamp_granularities[]"\r\n\r\nword\r\n'
        b"--xxBOUNDARYxx\r\n"
        b'Content-Disposition: form-data; '
        b'name="timestamp_granularities[]"\r\n\r\nsegment\r\n'
    )
    body = body.replace(b"--xxBOUNDARYxx--", extra + b"--xxBOUNDARYxx--")
    fields, _ = _rest(pkg).parse_multipart(ctype, body)
    assert fields["timestamp_granularities[]"] == "word,segment"
    assert _rest(pkg).parse_granularities({}, fields) == {"word", "segment"}


def test_multipart_repeated_scalar_field_last_wins(pkg):
    # only the known multi-valued keys comma-join; a client repeating a
    # scalar field (e.g. task) keeps last-wins instead of producing
    # "translate,translate" and a 400 (ADVICE r4 low)
    body, ctype = multipart_body(b"x", {"response_format": "json"})
    extra = (
        b"--xxBOUNDARYxx\r\n"
        b'Content-Disposition: form-data; name="task"\r\n\r\ntranscribe\r\n'
        b"--xxBOUNDARYxx\r\n"
        b'Content-Disposition: form-data; name="task"\r\n\r\ntranslate\r\n'
    )
    body = body.replace(b"--xxBOUNDARYxx--", extra + b"--xxBOUNDARYxx--")
    fields, _ = _rest(pkg).parse_multipart(ctype, body)
    assert fields["task"] == "translate"


def test_granularities_require_verbose_json(plane):
    # OpenAI rejects granularities outside verbose_json; silently
    # ignoring them hid client mistakes (ADVICE r4 low)
    for fmt in ("json", "text", "srt"):
        status, _, payload = post(
            plane, wav_bytes(),
            query={
                "response_format": [fmt],
                "timestamp_granularities[]": ["word"],
            },
        )
        assert status == 400, (fmt, payload)
        assert "verbose_json" in payload["message"]


# -- GET /v1/models ----------------------------------------------------------


def test_v1_models_lists_loaded_models(plane):
    status, ctype, payload = plane.handle(
        "GET", "/v1/models", {}, {}, b"", "9.8.251.1"
    )
    assert status == 200 and ctype == "application/json"
    assert payload["object"] == "list"
    ids = [m["id"] for m in payload["data"]]
    assert "default" in ids  # the boot model registers as "default"
    for m in payload["data"]:
        assert m["object"] == "model"
        # operational fields stay behind /admin/list_models
        assert "pending" not in m and "device" not in m


def test_v1_models_disabled_via_env(plane, monkeypatch):
    monkeypatch.setenv("STT_REST_TRANSCRIBE", "off")
    status, _, _ = plane.handle(
        "GET", "/v1/models", {}, {}, b"", "9.8.251.2"
    )
    assert status == 404


# -- body-size cap (socket layer) ---------------------------------------------


def test_oversized_body_rejected_before_buffering(runtime, pkg, monkeypatch):
    start_http_server = _http(pkg).start_http_server

    monkeypatch.setenv("STT_HTTP_MAX_BODY_MB", "0.001")  # ~1 KB cap
    handle = start_http_server(runtime, {"grpc_running": True},
                               "127.0.0.1", 0)
    try:
        url = (f"http://127.0.0.1:{handle.port}"
               f"/v1/audio/transcriptions")
        req = urllib.request.Request(
            url, data=wav_bytes(seconds=0.5), method="POST"
        )
        with pytest.raises(urllib.error.HTTPError) as exc_info:
            urllib.request.urlopen(req, timeout=5)
        assert exc_info.value.code == 413
        payload = json.loads(exc_info.value.read())
        assert payload["code"] == "payload_too_large"

        # under the cap the request flows normally
        monkeypatch.setenv("STT_HTTP_MAX_BODY_MB", "128")
        req = urllib.request.Request(
            url, data=wav_bytes(seconds=0.5), method="POST"
        )
        with urllib.request.urlopen(req, timeout=30) as resp:
            assert resp.status == 200
            assert "text" in json.loads(resp.read())
    finally:
        handle.stop(timeout=5)


# -- round-4 review regressions ----------------------------------------------


def test_parse_multipart_lf_only_and_binary_crlf(pkg):
    # LF-only separators (sloppy client) and CRLF bytes inside the payload
    boundary = "bb"
    payload = b"\x00\r\n\x01\xff--not-a-boundary\r\n"
    body = (
        b"--bb\nContent-Disposition: form-data; name=\"file\"\n\n"
        + payload
        + b"\n--bb\nContent-Disposition: form-data; name=\"language\"\n\nen\n--bb--\n"
    )
    fields, file_bytes = _rest(pkg).parse_multipart(
        f"multipart/form-data; boundary={boundary}", body
    )
    assert fields == {"language": "en"}
    assert file_bytes == payload


def test_parse_multipart_base64_transfer_encoding(pkg):
    import base64 as b64

    raw = bytes(range(256))
    body = (
        b"--bb\r\nContent-Disposition: form-data; name=\"file\"\r\n"
        b"Content-Transfer-Encoding: base64\r\n\r\n"
        + b64.b64encode(raw)
        + b"\r\n--bb--\r\n"
    )
    _, file_bytes = _rest(pkg).parse_multipart("multipart/form-data; boundary=bb", body)
    assert file_bytes == raw


def test_rest_context_forwards_metadata_and_ipv6_peer(pkg):
    extract_client_ip = _mod(pkg, "server.application.session_manager").extract_client_ip
    RestContext = _rest(pkg).RestContext
    _peer_for_ws = _mod(pkg, "server.transport.ws_server")._peer_for_ws

    ctx = RestContext(
        peer=_peer_for_ws("2001:db8::1"),
        metadata=[("authorization", "Bearer sig")],
    )
    # per-IP caps/limits must key on the full IPv6 address, not its
    # first hextet (the old "ipv4:2001:db8::1:0" label truncated at ":")
    assert extract_client_ip(ctx) == "2001:db8::1"
    assert ctx.invocation_metadata() == [("authorization", "Bearer sig")]


def test_signed_token_auth_over_rest(pkg):
    """The HMAC gauntlet must see the HTTP headers as invocation
    metadata, and the client must be able to supply the session_id its
    signature covers (regression: RestContext returned [] metadata, so
    signed_token deployments got ERR1014 on every REST request)."""
    import hashlib
    import hmac as hmac_mod
    import time as time_mod

    secret = "resttopsecret"
    cfg = _mod(pkg, "config.loader").ServerConfig(
        model="tiny", model_backend="fake", device="cpu",
        adaptive_throttle_enabled=False,
        create_session_auth_profile="signed_token",
        create_session_auth_secret=secret,
    )
    rt = _mod(pkg, "server.runtime.runtime").ApplicationRuntime(cfg)
    try:
        auth_plane = _http(pkg).HttpPlane(rt, {"grpc_running": True})
        body = wav_bytes()

        # no auth headers -> the gauntlet's ERR1014, mapped to HTTP
        status, _, payload = post(
            auth_plane, body, headers={"content-type": "audio/wav"}
        )
        assert status == 401, payload
        assert "ERR1014" in json.dumps(payload)

        # signed request: client picks the session_id it signs
        session_id = "rest-signed-1"
        ts = int(time_mod.time())
        sig = hmac_mod.new(
            secret.encode(), f"{session_id}:{ts}".encode(), hashlib.sha256
        ).hexdigest()
        status, _, payload = post(
            auth_plane, body,
            query={"session_id": [session_id]},
            headers={
                "content-type": "audio/wav",
                "authorization": f"Bearer {sig}",
                "x-stt-auth-ts": str(ts),
            },
        )
        assert status == 200, payload
        assert payload["text"].strip()
    finally:
        rt.shutdown(drain_timeout_sec=2.0)


def test_max_body_bytes_hostile_env_values(pkg, monkeypatch):
    _HTTP_MAX_BODY_MB_DEFAULT = _http(pkg)._HTTP_MAX_BODY_MB_DEFAULT
    _max_body_bytes = _http(pkg)._max_body_bytes

    default = int(_HTTP_MAX_BODY_MB_DEFAULT * 1024 * 1024)
    for hostile in ("nan", "-1", "garbage", "1e309-junk"):
        monkeypatch.setenv("STT_HTTP_MAX_BODY_MB", hostile)
        assert _max_body_bytes() == default, hostile
    # inf / overflowing values disable the cap instead of crashing
    import sys as sys_mod

    for huge in ("inf", "1e309"):
        monkeypatch.setenv("STT_HTTP_MAX_BODY_MB", huge)
        assert _max_body_bytes() == sys_mod.maxsize, huge
    monkeypatch.setenv("STT_HTTP_MAX_BODY_MB", "0.5")
    assert _max_body_bytes() == 512 * 1024


def test_malformed_content_length_is_400(runtime, pkg):
    import http.client

    start_http_server = _http(pkg).start_http_server

    handle = start_http_server(runtime, {"grpc_running": True},
                               "127.0.0.1", 0)
    try:
        conn = http.client.HTTPConnection("127.0.0.1", handle.port,
                                          timeout=5)
        conn.putrequest("POST", "/v1/audio/transcriptions",
                        skip_accept_encoding=True)
        conn.putheader("Content-Length", "abc")
        conn.endheaders()
        resp = conn.getresponse()
        payload = json.loads(resp.read())
        assert resp.status == 400
        assert payload["code"] == "invalid_request"
        conn.close()
    finally:
        handle.stop()


# -- side by side: the same bytes give the same answers ------------------------


@pytest.fixture(scope="module")
def planes():
    """One plane of each package over its own runtime (fake backend)."""
    rts = {p: _make_runtime(p) for p in PACKAGES}
    yield {p: _http(p).HttpPlane(rt, {"grpc_running": True}) for p, rt in rts.items()}
    for rt in rts.values():
        rt.shutdown(drain_timeout_sec=2.0)


WAVS = {
    "mono": wav_bytes(seconds=0.5),
    "stereo": wav_bytes(seconds=0.3, channels=2),
    "rate_8k": wav_bytes(seconds=0.4, sr=8000),
    "garbage": b"definitely not a wav",
}


@pytest.mark.parametrize("name", sorted(WAVS))
def test_parse_wav_matches_the_jax_parser(name):
    def parse(pkg):
        try:
            return _rest(pkg).parse_wav_bytes(WAVS[name])
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert parse("stt_tpu_torch") == parse("stt_tpu")


def _multipart_cases():
    body, ctype = multipart_body(b"\x00\x01\xff\xfe", {"language": "en", "task": "translate"})
    yield "plain", ctype, body
    lf = (b"--bb\nContent-Disposition: form-data; name=\"file\"\n\n\x00\r\n\x01"
          b"\n--bb\nContent-Disposition: form-data; name=\"language\"\n\nen\n--bb--\n")
    yield "lf_only", "multipart/form-data; boundary=bb", lf
    repeated = body.replace(
        b"--xxBOUNDARYxx--",
        b"--xxBOUNDARYxx\r\nContent-Disposition: form-data; "
        b"name=\"timestamp_granularities[]\"\r\n\r\nword\r\n"
        b"--xxBOUNDARYxx\r\nContent-Disposition: form-data; "
        b"name=\"timestamp_granularities[]\"\r\n\r\nsegment\r\n--xxBOUNDARYxx--")
    yield "repeated", ctype, repeated
    yield "no_boundary", "multipart/form-data", body


@pytest.mark.parametrize("case", list(_multipart_cases()), ids=lambda c: c[0])
def test_parse_multipart_matches_the_jax_parser(case):
    _, ctype, body = case

    def parse(pkg):
        try:
            fields, data = _rest(pkg).parse_multipart(ctype, body)
            return fields, data, _rest(pkg).parse_granularities({}, fields)
        except ValueError as exc:
            return ("ValueError", str(exc))

    assert parse("stt_tpu_torch") == parse("stt_tpu")


REQUESTS = [
    ("json", {}, "/v1/audio/transcriptions"),
    ("verbose_json", {"response_format": ["verbose_json"]}, "/v1/audio/transcriptions"),
    ("text", {"response_format": ["text"]}, "/v1/audio/transcriptions"),
    ("srt", {"response_format": ["srt"]}, "/v1/audio/transcriptions"),
    ("vtt", {"response_format": ["vtt"]}, "/v1/audio/transcriptions"),
    ("translate", {"response_format": ["verbose_json"]}, "/v1/audio/translations"),
    ("bad_format", {"response_format": ["yaml"]}, "/v1/audio/transcriptions"),
    ("bad_task", {"task": ["summon"]}, "/v1/audio/transcriptions"),
    ("conflict", {"task": ["transcribe"]}, "/v1/audio/translations"),
    ("bad_granularity", {"timestamp_granularities[]": ["sentence"]},
     "/v1/audio/transcriptions"),
    ("bad_profile", {"decode_profile": ["nope"]}, "/v1/audio/transcriptions"),
]


@pytest.mark.parametrize("req", REQUESTS, ids=lambda r: r[0])
def test_answers_match_the_jax_plane(planes, req):
    """The fake backend is the same in both packages, so the two planes
    give the same status, content type and payload for the same WAV."""
    _, query, path = req
    got = {p: post(plane, wav_bytes(seconds=1.5), query=query, path=path,
                   headers={"content-type": "audio/wav"})
           for p, plane in planes.items()}
    assert got["stt_tpu_torch"] == got["stt_tpu"]


# -- end to end: both servers on the test model --------------------------------


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _http_get(port, path, timeout=5.0):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}", timeout=timeout) as r:
        return r.status, r.read()


def _http_post(port, path, body, timeout=300.0):
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body,
                                 method="POST", headers={"content-type": "audio/wav"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as exc:
        return exc.code, json.loads(exc.read())


@contextlib.contextmanager
def _server(pkg, model_config=None):
    """One server as a subprocess (the ``test`` model, float32, seed 0,
    English, and ``--model-config model_config`` when given), yielding its
    HTTP port once ``/health`` answers 200."""
    http_port = _free_port()
    extra = [] if model_config is None else ["--model-config", str(model_config)]
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2"}
    backend = {"stt_tpu": "jax_whisper", "stt_tpu_torch": "torch_whisper"}[pkg]
    server_log = tempfile.TemporaryFile()
    proc = subprocess.Popen(
        [sys.executable, "-m", f"{pkg}.server.main", "--model", "test",
         "--model-backend", backend, "--device", "cpu", "--compute-type", "float32",
         "--language", "en", "--language-fix", "--decode-timeout", "120",
         "--port", str(_free_port()), "--metrics-port", str(http_port),
         "--ws-port", "0", *extra],
        cwd=REPO, env=env, stdout=server_log, stderr=subprocess.STDOUT,
    )
    try:
        deadline = time.monotonic() + 180
        while True:
            if proc.poll() is not None:
                server_log.seek(0)
                raise RuntimeError(f"{pkg} server exited early:\n"
                                   f"{server_log.read().decode(errors='replace')}")
            try:
                if _http_get(http_port, "/health", timeout=1.0)[0] == 200:
                    break
            except (OSError, urllib.error.URLError):
                pass
            if time.monotonic() > deadline:
                raise TimeoutError(f"{pkg} server: /health not 200 in 180 s")
            time.sleep(0.2)
        yield http_port
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        server_log.close()


def _tone_wav(seconds: float, seed: int) -> bytes:
    rng = np.random.default_rng(seed)
    t = np.arange(int(16000 * seconds)) / 16000
    x = 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(0, 1, t.shape)
    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(16000)
        wf.writeframes((np.clip(x, -1, 1) * 32767).astype(np.int16).tobytes())
    return buf.getvalue()


def test_rest_end_to_end_matches_the_jax_server(tmp_path):
    import yaml

    # the shipped profiles, `accurate` with word timestamps
    raw = yaml.safe_load((REPO / "config/model.yaml").read_text())
    raw["model"]["decode_profiles"]["accurate"]["word_timestamps"] = True
    model_config = tmp_path / "model.yaml"
    model_config.write_text(yaml.safe_dump(raw))
    wav = _tone_wav(2.0, seed=11)
    realtime = "/v1/audio/transcriptions?decode_profile=realtime&response_format=verbose_json"
    got = {}
    with contextlib.ExitStack() as stack:
        ports = {p: stack.enter_context(_server(p, model_config)) for p in PACKAGES}
        for p, port in ports.items():
            got[p] = _http_post(port, realtime, wav)
        # the port's health and metrics carry the JAX plane's keys
        health = {p: json.loads(_http_get(port, "/health")[1]) for p, port in ports.items()}
        assert set(health["stt_tpu_torch"]) == set(health["stt_tpu"])
        assert health["stt_tpu_torch"]["status"] == "ok"
        metrics = {p: json.loads(_http_get(port, "/metrics.json")[1])
                   for p, port in ports.items()}
        assert set(metrics["stt_tpu_torch"]) == set(metrics["stt_tpu"])
        # no profile: accurate (beam 5, word timestamps), served by both planes
        # alike; then the port's server serves a realtime request again
        accurate = {p: _http_post(port, "/v1/audio/transcriptions?response_format="
                                  "verbose_json&timestamp_granularities=word"
                                  "&timestamp_granularities=segment", wav)
                    for p, port in ports.items()}
        again = _http_post(ports["stt_tpu_torch"], realtime, wav)
    (js, jp), (ts, tp) = got["stt_tpu"], got["stt_tpu_torch"]
    assert js == ts == 200, (jp, tp)
    assert tp["text"].strip()
    assert tp["text"] == jp["text"]
    assert tp["segments"] == jp["segments"]
    assert again == got["stt_tpu_torch"]
    (js, jp), (ts, tp) = accurate["stt_tpu"], accurate["stt_tpu_torch"]
    assert js == ts == 200, (jp, tp)
    assert tp["text"].strip()
    assert tp["text"] == jp["text"]
    assert tp["segments"] == jp["segments"]
    assert tp["words"] and tp["words"] == jp["words"], (tp.get("words"), jp.get("words"))
    assert "words" not in got["stt_tpu_torch"][1]

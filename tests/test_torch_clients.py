"""The port's CLI clients and SDK against the JAX package's.

``stt_tpu_torch/client/`` holds its own copies of ``stt_tpu/client/``
(``common``, ``sdk``, ``realtime_file``, ``mic``, ``batch_file``, their YAML
defaults and the demo clip), importing the port's ``gen`` and
``utils.subtitles``. The cases of ``tests/test_client_common.py`` and
``tests/test_sdk.py`` run here on both packages; each client's ``--help``
is the original's with the package renamed; and the batch client (the
``accurate`` profile, beam 5, by default) and the realtime-file client
(partials off, unpaced) stream the bundled clip to both servers (``test``
model, float32, seed 0, language en) as subprocesses, each client of each
package against each server, and print the same finals.
"""

import hashlib
import hmac
import importlib
import os
import subprocess
import sys
import time
import wave
from pathlib import Path

import grpc
import numpy as np
import pytest

from tests.test_torch_server import _server, integration

PACKAGES = ("stt_tpu", "stt_tpu_torch")
CLIENTS = ("batch_file", "realtime_file", "mic")
REPO = Path(__file__).resolve().parents[1]


def _client(pkg, name):
    return importlib.import_module(f"{pkg}.client.{name}")


def _write_wav(path, samples, sr=16000, sampwidth=2, channels=1):
    with wave.open(str(path), "wb") as wf:
        wf.setnchannels(channels)
        wf.setsampwidth(sampwidth)
        wf.setframerate(sr)
        wf.writeframes(samples)


# -- tests/test_client_common.py, on both packages ---------------------------------


@pytest.mark.parametrize("pkg", PACKAGES)
def test_load_wav_16bit_mono(pkg, tmp_path):
    samples = (np.arange(1600, dtype=np.int16) * 3).tobytes()
    _write_wav(tmp_path / "a.wav", samples)
    audio, sr = _client(pkg, "common").load_audio(str(tmp_path / "a.wav"))
    assert sr == 16000
    assert audio.dtype == np.int16
    assert len(audio) == 1600


@pytest.mark.parametrize("pkg", PACKAGES)
def test_load_wav_stereo_takes_left(pkg, tmp_path):
    left = np.arange(100, dtype=np.int16)
    inter = np.empty(200, np.int16)
    inter[0::2] = left
    inter[1::2] = -left
    _write_wav(tmp_path / "s.wav", inter.tobytes(), channels=2)
    audio, _ = _client(pkg, "common").load_audio(str(tmp_path / "s.wav"))
    np.testing.assert_array_equal(audio, left)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_chunk_stream_final_chunk(pkg):
    audio = np.zeros(16000, np.int16)
    chunks = list(_client(pkg, "common").chunk_stream(audio, 16000, 100, "s1",
                                                      realtime=False))
    assert len(chunks) == 11  # 10 x 100ms + empty final
    assert all(not c.is_final for c in chunks[:-1])
    assert chunks[-1].is_final and chunks[-1].pcm16 == b""
    assert all(c.session_id == "s1" for c in chunks)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_merge_transcript(pkg):
    merge = _client(pkg, "common").merge_transcript
    assert merge("", "hello") == "hello"
    assert merge("hello", "") == "hello"
    assert merge("hello", "hello world") == "hello world"
    assert merge("hello", "there") == "hello there"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_transcript_tracker_prefers_server_fields(pkg):
    common = _client(pkg, "common")
    tracker = common.TranscriptTracker()
    partial = common.stt_pb2.STTResult(text="x", is_final=False,
                                       committed_text="hello", unstable_text="wor")
    assert tracker.display_text(partial) == "hello wor"
    assert tracker.committed == "hello"
    final = common.stt_pb2.STTResult(text="x", is_final=True,
                                     committed_text="", unstable_text="world")
    assert tracker.display_text(final) == "world"


@pytest.mark.parametrize("pkg", PACKAGES)
def test_transcript_tracker_local_fallback(pkg):
    common = _client(pkg, "common")
    tracker = common.TranscriptTracker()
    assert tracker.display_text(common.stt_pb2.STTResult(text="hello wor")) == "hello wor"
    f = common.stt_pb2.STTResult(text="hello world", is_final=True)
    assert tracker.display_text(f) == "hello world"
    assert tracker.committed == "hello world"
    f2 = common.stt_pb2.STTResult(text="again", is_final=True)
    assert tracker.display_text(f2) == "hello world again"


# -- tests/test_sdk.py, on both packages -------------------------------------------


class FakeRpcError(grpc.RpcError):
    def __init__(self, code, details=""):
        self._code = code
        self._details = details

    def code(self):
        return self._code

    def details(self):
        return self._details


@pytest.mark.parametrize("pkg", PACKAGES)
def test_parse_error_code(pkg):
    sdk = _client(pkg, "sdk")
    assert sdk.parse_error_code(
        FakeRpcError(grpc.StatusCode.INVALID_ARGUMENT, "ERR1007 too big")) == "ERR1007"
    assert sdk.parse_error_code(FakeRpcError(grpc.StatusCode.UNKNOWN, "no code here")) is None


@pytest.mark.parametrize("pkg", PACKAGES)
def test_should_retry_status_filter(pkg):
    sdk = _client(pkg, "sdk")
    retry = sdk.RetryConfig(attempts=2)
    assert sdk._should_retry(FakeRpcError(grpc.StatusCode.UNAVAILABLE), retry, 0)
    assert sdk._should_retry(FakeRpcError(grpc.StatusCode.RESOURCE_EXHAUSTED), retry, 1)
    assert not sdk._should_retry(FakeRpcError(grpc.StatusCode.INVALID_ARGUMENT), retry, 0)
    # attempts exhausted
    assert not sdk._should_retry(FakeRpcError(grpc.StatusCode.UNAVAILABLE), retry, 2)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_backoff_exponential_with_cap(pkg):
    sdk = _client(pkg, "sdk")
    retry = sdk.RetryConfig(attempts=5, base_backoff_sec=0.5, max_backoff_sec=2.0)
    assert 0.3 <= sdk._backoff_delay(retry, 0) <= 0.7  # 0.5 +/- 20% jitter
    assert sdk._backoff_delay(retry, 3) <= 2.0 * 1.2   # capped at max (+jitter)


@pytest.mark.parametrize("pkg", PACKAGES)
def test_signed_token_metadata_roundtrip(pkg):
    md = _client(pkg, "sdk").build_signed_token_metadata("sess-1", "topsecret")
    assert [k for k, _ in md] == ["authorization", "x-stt-auth-ts"]
    sig = md[0][1].removeprefix("Bearer ")
    ts = md[1][1]
    assert sig == hmac.new(b"topsecret", f"sess-1:{ts}".encode(), hashlib.sha256).hexdigest()
    assert abs(int(ts) - time.time()) < 5


@pytest.mark.parametrize("pkg", PACKAGES)
def test_signed_token_metadata_empty_secret(pkg):
    sdk = _client(pkg, "sdk")
    assert sdk.build_signed_token_metadata("sess-1", "") == []
    assert sdk.build_signed_token_metadata("sess-1", None) == []


@pytest.mark.parametrize("pkg", PACKAGES)
def test_signed_metadata_accepted_by_session_manager(pkg):
    """The SDK's metadata satisfies the same package's HMAC validator."""
    sm = importlib.import_module(f"{pkg}.server.application.session_manager")
    gate = importlib.import_module(f"{pkg}.server.component.vad_gate")
    handler = sm.CreateSessionHandler(
        sm.CreateSessionConfig(create_session_auth_profile="signed_token",
                               create_session_auth_secret="topsecret",
                               create_session_auth_ttl_sec=60.0),
        sm.SessionRegistry(), gate.VADModelPool(),
    )

    class Ctx:
        def __init__(self, metadata):
            self._md = metadata

        def peer(self):
            return "ipv4:9.9.9.9:1"

        def invocation_metadata(self):
            return self._md

        def abort(self, code, details):
            raise AssertionError(f"aborted: {details}")

    md = _client(pkg, "sdk").build_signed_token_metadata("sdk-auth-1", "topsecret")
    resp = handler.handle(_client(pkg, "common").stt_pb2.SessionRequest(session_id="sdk-auth-1"),
                          Ctx(md))
    assert resp.vad_silence > 0


# -- the copies and the command lines ------------------------------------------------


def test_copies_differ_from_the_originals_only_in_names():
    for rel in [f"{n}.py" for n in ("__init__", "common", "sdk", *CLIENTS)] + [
            "config/file.yaml", "config/mic.yaml", "assets/hello.wav"]:
        orig = (REPO / "stt_tpu/client" / rel).read_bytes()
        port = (REPO / "stt_tpu_torch/client" / rel).read_bytes()
        renamed = orig.replace(b"stt_tpu/", b"stt_tpu_torch/").replace(
            b"stt_tpu.client", b"stt_tpu_torch.client")
        if rel == "sdk.py":  # the first docstring line names both servers
            port, renamed = port.split(b"\n", 1)[1], renamed.split(b"\n", 1)[1]
        assert port == renamed, rel


def _run(args, timeout=120, **kw):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, *args], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout, **kw)


@pytest.mark.parametrize("client", CLIENTS)
def test_help_is_the_originals(client):
    outs = {pkg: _run(["-m", f"{pkg}.client.{client}", "--help"]) for pkg in PACKAGES}
    for out in outs.values():
        assert out.returncode == 0, out.stderr
    assert outs["stt_tpu_torch"].stdout == outs["stt_tpu"].stdout.replace(
        "stt_tpu/", "stt_tpu_torch/")
    assert "jax" not in outs["stt_tpu_torch"].stderr


def _finals(stdout: str):
    """Text of every ``[FINAL]`` block a client printed."""
    lines = stdout.splitlines()
    return [lines[i + 2].split(" : ", 1)[1] for i, line in enumerate(lines)
            if line == "[FINAL]" and lines[i + 2].lstrip().startswith("text")]


@pytest.fixture(scope="module")
def streamed(tmp_path_factory):
    """Each package's batch and realtime-file clients against each server."""
    cfg = tmp_path_factory.mktemp("client") / "file.yaml"
    cfg.write_text("partial: false\nrealtime: false\n")
    commands = {
        "batch_file": ["--language", "en", "--no-metrics"],
        "realtime_file": ["--config", str(cfg), "--language", "en", "--no-metrics"],
    }
    out = {}
    servers = {"stt_tpu": "jax", "stt_tpu_torch": "torch"}
    for server_pkg, kind in servers.items():
        with _server(kind) as (port, _):
            for client_pkg in PACKAGES:
                for client, args in commands.items():
                    out[server_pkg, client_pkg, client] = _run(
                        ["-m", f"{client_pkg}.client.{client}",
                         "--target", f"127.0.0.1:{port}", *args], timeout=300)
    return out


@integration
@pytest.mark.parametrize("client", ["batch_file", "realtime_file"])
def test_clients_get_the_jax_servers_finals(streamed, client):
    """``batch_file`` asks for ``accurate`` (beam 5) by default; every run
    ends 0 with finals, and the port's server gives the JAX server's."""
    finals = {}
    for (server_pkg, client_pkg, name), proc in streamed.items():
        if name == client:
            assert proc.returncode == 0, proc.stdout + proc.stderr
            finals[server_pkg, client_pkg] = _finals(proc.stdout)
    want = finals["stt_tpu", "stt_tpu"]
    assert want and all(t.strip() for t in want), want
    assert all(got == want for got in finals.values()), finals

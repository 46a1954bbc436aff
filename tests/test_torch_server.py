"""The port's gRPC server against the JAX package's, and its copied modules.

``python -m stt_tpu.server.main`` and ``python -m stt_tpu_torch.server.main``
run as subprocesses on free ports, both serving the ``test`` model in float32
on the CPU with the same seed-0 weights, ``--language en --language-fix``,
the shipped YAML files, ``STT_DRAFT_PARTIALS=on`` (every partial, and a
final whose session holds a draft, rides the drafted decode) and no
WebSocket bridge. The same sessions stream to both:

- three with partials off (a final's text is merged onto what earlier
  partials committed, and partials fire on wall-clock timing, so finals are
  deterministic only without them): 2 s of tone and noise, a stream whose
  silence gap trips VAD endpointing, and 1 s at 8 kHz (the resample path).
  Every result (text, ``is_final``, language, start and end to 1e-6) and the
  trailing metadata's keys must be equal on both;
- one with ``partial="true"``, paced in real time: each server sends at
  least one partial and one final;
- one with ``DECODE_PROFILE_ACCURATE`` (beam 5), partials off: every result
  equal on both, as for the first three;
- drafted partials: 4 s of tone with ``partial="true"`` in 100 ms chunks
  paced in real time, once to warm the JAX server's drafted programs and
  once measured. Partials fire at 1.5 s and 3 s of audio (the interval
  counts received audio) and the final 1 s after the last one; the stream
  waits for each partial's result before sending on (``_stream``'s gates),
  so the results do not depend on how long a decode takes: every result
  (partials and final) equal on both, the second partial and the final
  drafted (each server's ``/metrics.json`` counts offered and accepted
  draft tokens);
- a second pair of servers on a model config whose only profile is a
  timestamp ``accurate`` one, so a session naming no profile takes the
  built-in realtime profile with ``condition_on_previous_text``: a gated
  session (2 s of tone, 1 s of silence, 3 s of tone, partials and a final
  at the VAD endpoint) whose committed final conditions every decode after
  it, every result equal on both; and one REST transcription on the
  timestamp profile, text and segments equal;
- the error probes (empty session id ERR1001, duplicate ERR1002, a 3 s chunk
  ERR1007) with the same codes on both.

The rest holds the port's copies to their originals: the proto and its
generated module, the config loader on the shipped YAML, the error codes,
the DSP VAD and the VAD gate, and the transcript-merging helpers. Gated
like the other integration tests by ``STT_SKIP_INTEGRATION=1``.
"""

import contextlib
import dataclasses
import json
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import grpc
import numpy as np
import pytest

from stt_tpu import errors as JERR
from stt_tpu.config import loader as JL
from stt_tpu.gen import stt_pb2 as JPB
from stt_tpu.gen import stt_pb2_grpc as JPBG
from stt_tpu.ops import vad as JVAD
from stt_tpu.server.component import decode_scheduler as JDS
from stt_tpu.server.component import vad_gate as JGATE
from stt_tpu_torch import errors as TERR
from stt_tpu_torch.config import loader as TL
from stt_tpu_torch.gen import stt_pb2 as TPB
from stt_tpu_torch.gen import stt_pb2_grpc as TPBG
from stt_tpu_torch.ops import vad as TVAD
from stt_tpu_torch.server import main as TMAIN
from stt_tpu_torch.server.component import decode_scheduler as TDS
from stt_tpu_torch.server.component import vad_gate as TGATE
from tests.test_api_contract import _field_entry, _load

REPO = Path(__file__).resolve().parents[1]
SR = 16000
MODULES = {"jax": "stt_tpu.server.main", "torch": "stt_tpu_torch.server.main"}
BACKENDS = {"jax": "jax_whisper", "torch": "torch_whisper"}

integration = pytest.mark.skipif(
    os.environ.get("STT_SKIP_INTEGRATION") == "1",
    reason="integration tests skipped (STT_SKIP_INTEGRATION=1)",
)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pcm(samples: np.ndarray) -> bytes:
    return (np.clip(samples, -1.0, 1.0) * 32767).astype(np.int16).tobytes()


def _tone(seconds: float, seed: int, rate: int = SR) -> np.ndarray:
    rng = np.random.default_rng(seed)
    t = np.arange(int(rate * seconds)) / rate
    return 0.3 * np.sin(2 * np.pi * 220 * t) + 0.05 * rng.normal(0, 1, t.shape)


# (audio, sample rate) of the sessions streamed with partials off
SESSIONS = {
    "tone": (_pcm(_tone(2.0, 3)), SR),
    "vad_gap": (_pcm(np.concatenate([_tone(1.5, 4), np.zeros(int(SR * 1.0)),
                                     _tone(1.0, 5)])), SR),
    "rate_8k": (_pcm(_tone(1.0, 6, rate=8000)), 8000),
}


@contextlib.contextmanager
def _server(kind: str, model_config=None, **env_vars: str):
    """One server as a subprocess with ``env_vars`` in its environment (and
    ``--model-config model_config`` when given), yielding its gRPC port and
    process once a channel to it is ready (the port's readiness signal; the
    JAX server's gRPC also starts only after its model is loaded); the
    process's ``metrics_port`` is its HTTP plane's."""
    port, metrics_port = _free_port(), _free_port()
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "OMP_NUM_THREADS": "2", **env_vars}
    server_log = tempfile.TemporaryFile()
    extra = [] if model_config is None else ["--model-config", str(model_config)]
    proc = subprocess.Popen(
        [sys.executable, "-m", MODULES[kind], "--model", "test",
         "--model-backend", BACKENDS[kind], "--device", "cpu",
         "--compute-type", "float32", "--language", "en", "--language-fix",
         "--decode-timeout", "120", "--port", str(port),
         "--metrics-port", str(metrics_port), "--ws-port", "0", *extra],
        cwd=REPO, env=env, stdout=server_log, stderr=subprocess.STDOUT,
    )
    try:
        channel = grpc.insecure_channel(f"127.0.0.1:{port}")
        deadline = time.monotonic() + 180
        while True:
            if proc.poll() is not None:
                server_log.seek(0)
                raise RuntimeError(f"{kind} server exited early:\n"
                                   f"{server_log.read().decode(errors='replace')}")
            try:
                grpc.channel_ready_future(channel).result(timeout=1.0)
                break
            except grpc.FutureTimeoutError:
                if time.monotonic() > deadline:
                    raise
        channel.close()
        proc.metrics_port = metrics_port
        yield port, proc
    finally:
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=30)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        server_log.close()


# how long a gate waits for the results it names
GATE_WAIT_SEC = 180.0


def _stream(port: int, sid: str, pcm: bytes, rate: int, *, attributes=None,
            profile=JPB.DECODE_PROFILE_UNSPECIFIED, chunk_sec: float = 0.2,
            pace: float = 0.0, gates=None):
    """CreateSession, then stream ``pcm`` in chunks and an ``is_final``
    chunk; returns (results, trailing metadata keys). ``gates`` maps a count
    of chunks sent to a count of results: after sending that many chunks
    the stream waits until that many results have arrived, sending an empty
    chunk every ``chunk_sec`` meanwhile (a server emits ready results when a
    chunk arrives; an empty one adds no audio, moves no VAD state and
    schedules nothing). A server schedules partials on the audio it has
    received, so with a gate after each partial point the sessions do not
    depend on how long a decode takes: every decode sees the same audio and
    the same earlier results on both servers, however loaded the host."""
    gates = dict(gates or {})
    results: list = []
    arrived = threading.Condition()
    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        stub = JPBG.STTBackendStub(channel)
        stub.CreateSession(JPB.SessionRequest(session_id=sid, attributes=attributes or {},
                                              decode_profile=profile), timeout=60)
        step = int(rate * chunk_sec) * 2

        def chunks():
            for sent, i in enumerate(range(0, len(pcm), step), start=1):
                if pace:
                    time.sleep(chunk_sec / pace)
                yield JPB.AudioChunk(session_id=sid, pcm16=pcm[i:i + step], sample_rate=rate)
                deadline = time.monotonic() + GATE_WAIT_SEC
                while len(results) < gates.get(sent, 0):
                    if time.monotonic() > deadline:
                        raise TimeoutError(f"{sid}: {len(results)} results after "
                                           f"{sent} chunks, gate wants {gates[sent]}")
                    with arrived:
                        arrived.wait(timeout=chunk_sec)
                    yield JPB.AudioChunk(session_id=sid, pcm16=b"", sample_rate=rate)
            yield JPB.AudioChunk(session_id=sid, is_final=True, sample_rate=rate)

        call = stub.StreamingRecognize(chunks(), metadata=(("session-id", sid),),
                                       timeout=480)
        for result in call:
            with arrived:
                results.append(result)
                arrived.notify_all()
        return results, sorted(k for k, _ in call.trailing_metadata())


# partials fire at 1.5 s and 3 s of received audio (chunks 15 and 30 of
# 100 ms): the stream waits for each one's result a few chunks later
DRAFTED_GATES = {18: 1, 33: 2}


@pytest.fixture(scope="module")
def served():
    """Both servers; every session of the module streamed to each once."""
    out = {}
    with contextlib.ExitStack() as stack:
        servers = {kind: stack.enter_context(_server(kind, STT_DRAFT_PARTIALS="on"))
                   for kind in MODULES}
        ports = {kind: server[0] for kind, server in servers.items()}
        for kind, port in ports.items():
            got = {name: _stream(port, f"{kind}-{name}", pcm, rate)
                   for name, (pcm, rate) in SESSIONS.items()}
            got["partial"] = _stream(port, f"{kind}-partial", _pcm(_tone(3.0, 7)), SR,
                                     attributes={"partial": "true"}, chunk_sec=0.1, pace=1.0)
            got["accurate"] = _stream(port, f"{kind}-accurate", _pcm(_tone(1.0, 9)), SR,
                                      profile=JPB.DECODE_PROFILE_ACCURATE)
            for name in ("drafted-warm", "drafted"):
                got[name] = _stream(port, f"{kind}-{name}", _pcm(_tone(4.0, 11)), SR,
                                    attributes={"partial": "true"}, chunk_sec=0.1, pace=1.0,
                                    gates=DRAFTED_GATES)
            got["metrics"] = _metrics_json(servers[kind][1].metrics_port)
            out[kind] = got
        yield ports, out


def _metrics_json(port: int) -> dict:
    import urllib.request

    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics.json", timeout=30) as resp:
        return json.loads(resp.read())


# the conditioned session: 2 s of tone, 1 s of silence, 3 s of tone, with
# partials and a final at the VAD endpoint: a partial (scheduled at chunk
# 15), the endpoint's final (chunk 25 or 26), whose text is committed, then
# two partials (chunks 40 or 41, 55 to 57) and the closing final, each
# decoded with the committed transcript as its conditioning prompt
COND_PCM = _pcm(np.concatenate([_tone(2.0, 12), np.zeros(SR), _tone(3.0, 13)]))
COND_GATES = {18: 1, 29: 2, 44: 3, 59: 4}
# a model config whose only profile is `accurate` with timestamps: a session
# that names no profile, and `realtime`, take the built-in realtime profile
# (``condition_on_previous_text`` on), as a config without decode_profiles
# does
TIMESTAMP_ACCURATE = {"beam_size": 5, "best_of": 5, "patience": 1.0, "temperature": 0.0,
                      "length_penalty": 1.0, "without_timestamps": False,
                      "compression_ratio_threshold": 2.4, "no_speech_threshold": 0.6,
                      "log_prob_threshold": -1.0}


def _wav(seconds: float, seed: int) -> bytes:
    import io
    import wave

    buf = io.BytesIO()
    with wave.open(buf, "wb") as wf:
        wf.setnchannels(1)
        wf.setsampwidth(2)
        wf.setframerate(SR)
        wf.writeframes(_pcm(_tone(seconds, seed)))
    return buf.getvalue()


def _http_post(port: int, path: str, body: bytes):
    import urllib.request

    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=body, method="POST",
                                 headers={"content-type": "audio/wav"})
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.status, json.loads(resp.read())


@pytest.fixture(scope="module")
def cond_served(tmp_path_factory):
    """Both servers on a model config with no realtime profile (so the
    built-in one, conditioning on the committed transcript) and a timestamp
    `accurate` profile, under ``STT_DRAFT_PARTIALS=on``: the conditioned
    session streamed to each with its gates, then one REST transcription
    with ``decode_profile=accurate``."""
    import yaml

    raw = yaml.safe_load((REPO / "config/model.yaml").read_text())
    raw["model"]["decode_profiles"] = {"accurate": TIMESTAMP_ACCURATE}
    model_config = tmp_path_factory.mktemp("cond") / "model.yaml"
    model_config.write_text(yaml.safe_dump(raw))
    out = {}
    with contextlib.ExitStack() as stack:
        for kind in MODULES:
            port, proc = stack.enter_context(_server(kind, model_config,
                                                     STT_DRAFT_PARTIALS="on"))
            out[kind] = {
                "cond": _stream(port, f"{kind}-cond", COND_PCM, SR, chunk_sec=0.1, pace=1.0,
                                attributes={"partial": "true", "emit_final_on_vad": "true"},
                                gates=COND_GATES),
                "rest": _http_post(proc.metrics_port, "/v1/audio/transcriptions?"
                                   "decode_profile=accurate&response_format=verbose_json",
                                   _wav(2.0, 14)),
            }
    return out


def _rows(results):
    return [(r.text, r.is_final, r.language_code, r.start_sec, r.end_sec) for r in results]


@integration
@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_results_equal_to_jax_server(served, session):
    _, out = served
    (j_res, _), (t_res, _) = out["jax"][session], out["torch"][session]
    j_rows, t_rows = _rows(j_res), _rows(t_res)
    assert any(r[1] for r in t_rows), t_rows
    assert len(t_rows) == len(j_rows), (t_rows, j_rows)
    for t, j in zip(t_rows, j_rows):
        assert t[:3] == j[:3]
        assert t[3] == pytest.approx(j[3], abs=1e-6)
        assert t[4] == pytest.approx(j[4], abs=1e-6)
    for text, is_final, lang, start, end in t_rows:
        if is_final:
            assert text.strip() and lang == "en"
            assert 0.0 <= start <= end <= len(SESSIONS[session][0]) / 2 / SESSIONS[session][1] + 0.5


@integration
@pytest.mark.parametrize("session", sorted(SESSIONS))
def test_trailing_metadata_keys_equal(served, session):
    _, out = served
    keys = out["torch"][session][1]
    assert keys == out["jax"][session][1]
    assert {"stt-decode-buffer-wait-sec", "stt-decode-queue-wait-sec",
            "stt-decode-inference-sec", "stt-decode-response-emit-sec"} <= set(keys)


@integration
@pytest.mark.parametrize("kind", sorted(MODULES))
def test_partials_and_final(served, kind):
    _, out = served
    results, _ = out[kind]["partial"]
    assert any(not r.is_final and r.text.strip() for r in results), _rows(results)
    assert any(r.is_final and r.text.strip() for r in results), _rows(results)


def _probe(port: int, probe: str) -> str:
    """The error details of one probe on one server."""
    with grpc.insecure_channel(f"127.0.0.1:{port}") as channel:
        stub = JPBG.STTBackendStub(channel)
        try:
            if probe == "empty_session_id":
                stub.CreateSession(JPB.SessionRequest(session_id=""), timeout=30)
            elif probe == "duplicate_session":
                sid = f"dup-{port}"
                stub.CreateSession(JPB.SessionRequest(session_id=sid), timeout=30)
                stub.CreateSession(JPB.SessionRequest(session_id=sid), timeout=30)
            else:  # a 3 s chunk, over max_chunk_ms 2000
                sid = f"long-{port}"
                stub.CreateSession(JPB.SessionRequest(session_id=sid), timeout=30)
                chunk = JPB.AudioChunk(session_id=sid, pcm16=_pcm(_tone(3.0, 8)),
                                       sample_rate=SR)
                list(stub.StreamingRecognize(iter([chunk]), metadata=(("session-id", sid),),
                                             timeout=60))
        except grpc.RpcError as exc:
            return f"{exc.code().name} {exc.details()}"
        return "no error"


@integration
@pytest.mark.parametrize("probe,code", [("empty_session_id", "ERR1001"),
                                        ("duplicate_session", "ERR1002"),
                                        ("long_chunk", "ERR1007")])
def test_error_probes_equal(served, probe, code):
    ports, _ = served
    got = {kind: _probe(port, probe) for kind, port in ports.items()}
    assert got["torch"].split()[:2] == got["jax"].split()[:2], got
    assert got["torch"].split()[1] == code, got


@integration
def test_accurate_profile_equals_the_jax_server(served):
    """The ``accurate`` profile (beam 5) is served, with the JAX server's
    results; a default session on the same server still gets its final."""
    ports, out = served
    (j_res, j_keys), (t_res, t_keys) = out["jax"]["accurate"], out["torch"]["accurate"]
    assert any(r.is_final and r.text.strip() for r in t_res), _rows(t_res)
    assert [r[:3] for r in _rows(t_res)] == [r[:3] for r in _rows(j_res)]
    for t, j in zip(_rows(t_res), _rows(j_res)):
        assert t[3:] == pytest.approx(j[3:], abs=1e-6)
    assert t_keys == j_keys
    results, _ = _stream(ports["torch"], "after-accurate", _pcm(_tone(1.0, 10)), SR)
    assert any(r.is_final and r.text.strip() for r in results)


@integration
def test_drafted_partials_equal_to_jax_server(served):
    """Under ``STT_DRAFT_PARTIALS=on`` the port's partials and final (the
    second partial and the final verify the previous partial's tokens)
    equal the JAX server's, and both servers count drafted tokens."""
    _, out = served
    (j_res, j_keys), (t_res, t_keys) = out["jax"]["drafted"], out["torch"]["drafted"]
    t_rows, j_rows = _rows(t_res), _rows(j_res)
    assert sum(not r[1] for r in t_rows) >= 2 and t_rows[-1][1], t_rows
    assert len(t_rows) == len(j_rows), (t_rows, j_rows)
    for t, j in zip(t_rows, j_rows):
        assert t[:3] == j[:3]
        assert t[3:] == pytest.approx(j[3:], abs=1e-6)
    assert t_keys == j_keys
    for kind in MODULES:
        metrics = out[kind]["metrics"]
        assert metrics["draft_rows"] > 0, (kind, metrics)
        assert 0 <= metrics["draft_tokens_accepted"] <= metrics["draft_tokens_offered"], kind
        assert metrics["draft_tokens_offered"] > 0, (kind, metrics)


@integration
def test_conditioned_session_equals_the_jax_server(cond_served):
    """Under the built-in profile every decode after the endpoint's final
    carries the committed transcript as its conditioning prompt (drafted
    partials included); every result equals the JAX server's."""
    (j_res, j_keys), (t_res, t_keys) = cond_served["jax"]["cond"], cond_served["torch"]["cond"]
    t_rows, j_rows = _rows(t_res), _rows(j_res)
    assert [r[1] for r in t_rows] == [False, True, False, False, True], t_rows
    # the committed final is long enough to condition on (8 tokens at least)
    assert len(t_rows[1][0].split()) >= 8, t_rows
    assert len(t_rows) == len(j_rows), (t_rows, j_rows)
    for t, j in zip(t_rows, j_rows):
        assert t[:3] == j[:3]
        assert t[3:] == pytest.approx(j[3:], abs=1e-6)
    assert t_keys == j_keys


@integration
def test_rest_timestamp_profile_equals_the_jax_server(cond_served):
    """One REST transcription on the timestamp `accurate` profile (beam 5):
    the JAX server's text and timed segments."""
    (j_status, j_body), (t_status, t_body) = (cond_served["jax"]["rest"],
                                              cond_served["torch"]["rest"])
    assert j_status == t_status == 200
    assert t_body["text"].strip() and t_body["text"] == j_body["text"]
    assert t_body["segments"] == j_body["segments"]


# -- copies against their originals --------------------------------------------------


def test_proto_and_generated_module_are_copies():
    assert (REPO / "stt_tpu_torch/proto/stt.proto").read_bytes() == \
        (REPO / "stt_tpu/proto/stt.proto").read_bytes()
    assert TPB.DESCRIPTOR.serialized_pb == JPB.DESCRIPTOR.serialized_pb
    for name in ("_SERVICE", "_CREATE_SESSION", "_STREAMING_RECOGNIZE"):
        assert getattr(TPBG, name) == getattr(JPBG, name)


@pytest.mark.parametrize("message", ["SessionRequest", "SessionResponse", "AudioChunk",
                                     "STTResult"])
def test_proto_fields_match_contract(message):
    contract = _load("stt_proto_contract.json")
    actual = {f.name: _field_entry(f) for f in getattr(TPB, message).DESCRIPTOR.fields}
    for pinned in contract[message]:
        assert actual[pinned["name"]] == pinned


@pytest.mark.parametrize("argv", [[], ["--model", "test", "--device", "cpu",
                                       "--language", "en", "--port", "50999"]])
def test_config_equal_to_jax(argv):
    from stt_tpu.server import main as JMAIN

    j = JMAIN.configure_from_args(JMAIN.parse_args(argv))
    t = TMAIN.configure_from_args(TMAIN.parse_args(argv))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert dataclasses.asdict(TL.load_config()) == dataclasses.asdict(JL.load_config())


@pytest.mark.parametrize("name", [c.name for c in JERR.ErrorCode])
def test_error_codes_equal(name):
    j, t = JERR.ErrorCode[name], TERR.ErrorCode[name]
    assert t.value == j.value
    assert dataclasses.astuple(TERR.ERROR_SPECS[t]) == dataclasses.astuple(JERR.ERROR_SPECS[j])


@pytest.mark.parametrize("seed", [0, 1])
def test_vad_step_bit_equal(seed):
    rng = np.random.default_rng(seed)
    frames = (rng.normal(0, 0.1, (12, JVAD.VAD_FRAME_SAMPLES))
              * np.linspace(0, 2, 12)[:, None]).astype(np.float32)
    j_state, t_state = JVAD.init_state(np), TVAD.init_state(np)
    for lo in range(0, 12, 4):
        j_probs, j_state = JVAD.vad_step(np, frames[lo:lo + 4], j_state)
        t_probs, t_state = TVAD.vad_step(np, frames[lo:lo + 4], t_state)
        np.testing.assert_array_equal(t_probs, j_probs)
        for a, b in zip(t_state, j_state):
            np.testing.assert_array_equal(a, b)


def test_vad_gate_decisions_identical():
    rng = np.random.default_rng(11)
    audio = np.concatenate([_tone(1.0, 12), 0.001 * rng.normal(0, 1, SR), _tone(0.7, 13),
                            np.zeros(SR)])
    pcm = _pcm(audio)
    j_gate = JGATE.VADGate(0.5, 0.5, JGATE.VADModelPool())
    t_gate = TGATE.VADGate(0.5, 0.5, TGATE.VADModelPool())
    step = int(0.1 * SR) * 2
    decisions = []
    for i in range(0, len(pcm), step):
        j, t = j_gate.update(pcm[i:i + step], SR), t_gate.update(pcm[i:i + step], SR)
        assert dataclasses.astuple(t) == dataclasses.astuple(j)
        decisions.append(t.triggered)
        if t.triggered:
            j_gate.reset_after_trigger()
            t_gate.reset_after_trigger()
    assert any(decisions)


MERGE_CASES = [("", "hello"), ("hello", ""), ("hello", "hello world"),
               ("hello world", "world again"), (" a ", " b "), ("", "")]
COMMIT_CASES = [("", "", "hello world"), ("", "hello there", "hello world"),
                ("hello", "hello there friend", "hello there pal"),
                ("", "one. two", "one. three"), ("x", "x y", "x y z"), ("", "", "")]


@pytest.mark.parametrize("prefix,text", MERGE_CASES)
def test_merge_transcript_equal(prefix, text):
    assert TDS.merge_transcript(prefix, text) == JDS.merge_transcript(prefix, text)


@pytest.mark.parametrize("committed,previous,current", COMMIT_CASES)
def test_commit_from_partials_equal(committed, previous, current):
    assert TDS.commit_from_partials(committed, previous, current) == \
        JDS.commit_from_partials(committed, previous, current)


def test_server_module_is_the_port():
    out = subprocess.run([sys.executable, "-m", "stt_tpu_torch.server.main", "--help"],
                         cwd=REPO, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "--tpu-mesh-shape" in out.stdout and "torch_whisper" in out.stdout
    code = ("import json, sys, stt_tpu_torch.server.main\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith(('jax.', 'stt_tpu.')))))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout) == []

"""Whole runs with the timed path broken underneath: ``correct`` has to come
out false for every fault a serving cell can have, and true for the sound
path; and false for the control, the reference computed in fp8 in the
program's place. CPU rehearsals at the port's ``test`` size, a small mix,
every finished request judged; the limits are this size's, a few times
what sound rehearsals read. The card test runs the control at each cell's
own size against the cell's own limits."""

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
LIMITS = {"token_gap": 0.01, "forbidden": 0, "logprob_err": 0.01, "no_speech_err": 0.01,
          "errors": 0}


@pytest.fixture
def small_root(tmp_path, monkeypatch):
    from benchmark.core import check

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    path = tmp_path / "benchmark" / "traffic" / "small.live.json"
    mix = json.loads(path.read_text())
    mix.update(sessions=3, lead_s=2.0, limits=LIMITS)
    path.write_text(json.dumps(mix))
    monkeypatch.setattr(check, "SAMPLE", 10000)    # every finished request
    monkeypatch.setattr(check, "LONGEST", 1)
    return tmp_path


def rehearse(root, monkeypatch, capsys, workload="small.live", seed=2**31 + 17, *extra):
    from benchmark import run as harness

    monkeypatch.setattr(harness, "ROOT", root)
    rc = harness.main(["--workload", workload, "--seed", str(seed), "--seconds", "4",
                       "--trace", "0", "--rehearse", *extra])
    assert rc == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_sound_rehearsal_is_correct(small_root, monkeypatch, capsys):
    result = rehearse(small_root, monkeypatch, capsys)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] > 0 and result["failed"] == 0


def test_a_step_that_leaves_the_state_unchanged_is_caught(small_root, monkeypatch, capsys):
    from stt_tpu_torch.models import whisper as W

    monkeypatch.setattr(W, "_decode_chunk", lambda *a, **k: None)
    result = rehearse(small_root, monkeypatch, capsys)
    assert result["correct"] is False, result["checks"]


def test_half_the_batch_left_out_is_caught(small_root, monkeypatch, capsys):
    from stt_tpu_torch.engine import engine as E

    device_phase = E.WhisperEngine._device_phase

    def half(self, group):
        # the back half of every group (a lone row too) reaches the card as
        # silence: its rows decode nothing that was sent
        for task in group[len(group) // 2:]:
            task.request = E.DecodeRequest(
                audio=task.request.audio * 0.0, language=task.request.language,
                options=task.request.options, is_final=task.request.is_final,
                session_id=task.request.session_id)
        return device_phase(self, group)

    monkeypatch.setattr(E.WhisperEngine, "_device_phase", half)
    result = rehearse(small_root, monkeypatch, capsys)
    assert result["correct"] is False, result["checks"]


def test_a_token_altered_where_it_is_produced_is_caught(small_root, monkeypatch, capsys):
    from stt_tpu_torch.engine import engine as E

    row_output = E.WhisperEngine._row_output

    def altered(self, *args, **kwargs):
        out = row_output(self, *args, **kwargs)
        if out._n_gen > 1:
            at = out._p_len + 1
            out._tokens[at] = (int(out._tokens[at]) + 7919) % 50000
        return out

    monkeypatch.setattr(E.WhisperEngine, "_row_output", altered)
    result = rehearse(small_root, monkeypatch, capsys)
    assert result["correct"] is False, result["checks"]


def test_the_control_is_not_correct_at_the_test_size(small_root, monkeypatch, capsys):
    result = rehearse(small_root, monkeypatch, capsys, "small.live", 2**31 + 18,
                      "--control", "fp8")
    assert result["correct"] is False, result["checks"]


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the control runs at the cell's own size")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["small.live", "turbo.live"])
def test_the_control_is_not_correct(card, workload):
    """The reference computed in fp8, the precision below the configuration's
    bf16, in the program's place at the cell's size and load."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    if workload not in {w["name"] for w in bench["workloads"]}:
        pytest.skip(f"{workload} is not a cell of BENCHMARK.json")
    out = subprocess.run(
        [sys.executable, str(ROOT / "benchmark" / "run.py"), "--workload", workload,
         "--seed", "2147483901", "--seconds", "10", "--trace", "0",
         "--control", "fp8"],
        capture_output=True, text=True, timeout=900, cwd=ROOT, env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"] is False, result["checks"]

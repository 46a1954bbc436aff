"""HF safetensors checkpoints in the port against the JAX package.

- The port's reader of the format (``stt_tpu_torch/utils/safetensors_io.py``)
  gives what ``safetensors.safe_open`` gives, bit for bit, on F32, F16 and
  BF16 files the ``safetensors`` package wrote; the port's writer's files
  read back through ``safe_open`` as written.
- Seed-0 ``test`` parameters exported by ``stt_tpu.parallel.checkpoint.
  export_hf_safetensors`` load through the port's ``load_hf_safetensors``
  into the tree the JAX package's loader gives: ``convert.from_jax_params``
  of both is equal bit for bit, and so is the config.
- The port's exporter (``stt_tpu_torch/parallel/checkpoint.py``) writes a
  directory that ``stt_tpu.models.whisper.load_hf_safetensors`` loads into
  the parameters it was given.
- An engine built from ``weights_path`` decodes the seed-built engine's
  tokens; without a vocabulary ``require_real`` refuses the checkpoint,
  and ``STT_ALLOW_FALLBACK_TOKENIZER=1`` opts out.
"""

import json

import jax
import numpy as np
import pytest
import torch
from safetensors import safe_open
from safetensors.torch import save_file

from stt_tpu.models import whisper as JW
from stt_tpu.parallel.checkpoint import export_hf_safetensors as jax_export
from stt_tpu_torch import convert
from stt_tpu_torch.engine import engine as TE
from stt_tpu_torch.models import whisper as TW
from stt_tpu_torch.models.tokenizer import FallbackTokenizer, load_tokenizer
from stt_tpu_torch.parallel.checkpoint import export_hf_safetensors
from stt_tpu_torch.utils import safetensors_io as S
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

CONFIG = TW.get_config("test")


def _tensors(dtype, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return {
        "a.weight": torch.randn(5, 7, generator=gen).to(dtype),
        "b": torch.randn(3, generator=gen).to(dtype),
        "c.scalar": torch.randn((), generator=gen).to(dtype),
        "d.empty": torch.zeros(0, 4, dtype=dtype),
        "e.big": (1e4 * torch.randn(2, 3, 4, generator=gen)).to(dtype),
    }


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_reader_equals_safe_open(tmp_path, dtype):
    path = str(tmp_path / "x.safetensors")
    save_file(_tensors(dtype), path, metadata={"format": "pt"})
    got = S.read_safetensors(path)
    with safe_open(path, framework="pt") as f:
        ref = {k: f.get_tensor(k) for k in f.keys()}
    assert set(got) == set(ref) == set(_tensors(dtype))
    for k in ref:
        assert got[k].dtype == ref[k].dtype == dtype and got[k].shape == ref[k].shape
        # bit for bit: the raw bytes of each tensor
        assert got[k].numpy().tobytes() == ref[k].numpy().tobytes() if dtype != torch.bfloat16 \
            else torch.equal(got[k].view(torch.int16), ref[k].view(torch.int16)), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_writer_reads_back_through_safe_open(tmp_path, dtype):
    path = str(tmp_path / "y.safetensors")
    tensors = _tensors(dtype, seed=1)
    n = S.write_safetensors(path, tensors)
    assert n == (tmp_path / "y.safetensors").stat().st_size
    with safe_open(path, framework="pt") as f:
        assert set(f.keys()) == set(tensors)
        for k, v in tensors.items():
            got = f.get_tensor(k)
            assert got.dtype == dtype and torch.equal(got.float(), v.float()), k
    assert all(torch.equal(S.read_safetensors(path)[k].float(), v.float())
               for k, v in tensors.items())


def test_reader_refuses_other_dtypes(tmp_path):
    path = str(tmp_path / "z.safetensors")
    save_file({"i": torch.arange(4)}, path)
    with pytest.raises(ValueError, match="I64"):
        S.read_safetensors(path)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "whisper-test")
    jparams = JW.init_params(JW.get_config("test"), seed=0)
    jax_export(path, jparams, JW.get_config("test"))
    return path


def _equal_trees(a, b):
    sa, sb = convert.from_jax_params(a), convert.from_jax_params(b)
    assert set(sa) == set(sb)
    return all(torch.equal(sa[k], sb[k]) for k in sa)


def test_loader_equals_the_jax_loader(jax_checkpoint):
    params, config = TW.load_hf_safetensors(jax_checkpoint)
    jparams, jconfig = JW.load_hf_safetensors(jax_checkpoint)
    assert _equal_trees(params, jax.tree.map(np.asarray, jparams))
    assert _equal_trees(params, TW.init_params(CONFIG, seed=0))
    assert config.__dict__ == {**jconfig.__dict__}
    assert config.name == "whisper-test"
    assert (config.n_mels, config.n_audio_state, config.n_text_layer, config.n_vocab) == \
        (CONFIG.n_mels, CONFIG.n_audio_state, CONFIG.n_text_layer, CONFIG.n_vocab)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_port_export_loads_in_the_jax_loader(tmp_path, dtype):
    path = str(tmp_path / "ckpt")
    params = TW.init_params(CONFIG, seed=0)
    n_bytes = export_hf_safetensors(path, params, CONFIG, dtype=dtype)
    assert n_bytes == (tmp_path / "ckpt" / "model.safetensors").stat().st_size
    with open(tmp_path / "ckpt" / "config.json") as f:
        assert json.load(f)["decoder_layers"] == CONFIG.n_text_layer
    loaded, config = TW.load_hf_safetensors(path)
    if dtype == torch.float32:
        # the JAX loader reads through numpy, which has no bfloat16
        jparams, _ = JW.load_hf_safetensors(path)
        assert _equal_trees(jax.tree.map(np.asarray, jparams), params)
        assert _equal_trees(loaded, params)
    else:
        rounded = convert.to_jax_params({k: v.to(torch.bfloat16).float()
                                         for k, v in convert.from_jax_params(params).items()})
        assert _equal_trees(loaded, rounded)


@pytest.mark.parametrize("compute_type", ["float32", "bfloat16"])
def test_engine_from_weights_path_decodes_the_seed_engines_tokens(
        tmp_path, monkeypatch, compute_type):
    path = str(tmp_path / "ckpt")
    export_hf_safetensors(path, TW.init_params(CONFIG, seed=0), CONFIG,
                          dtype=torch.bfloat16 if compute_type == "bfloat16" else torch.float32)
    kw = dict(device="cpu", compute_type=compute_type, audio_buckets_sec=(1.0,),
              batch_buckets=(4,), max_decode_tokens=16)
    monkeypatch.setenv("STT_ALLOW_FALLBACK_TOKENIZER", "1")
    loaded = TE.WhisperEngine("ignored", weights_path=path, **kw)
    seeded = TE.WhisperEngine("test", **kw)
    assert loaded.config.n_text_state == CONFIG.n_text_state and loaded.load_seconds > 0
    rng = np.random.default_rng(2)
    rows = [TE._Task(TE.DecodeRequest((0.1 * rng.standard_normal(12000)).astype(np.float32),
                                      language=lang), None) for lang in ("en", None, "de")]
    a = loaded._harvest(loaded._device_phase(rows))
    b = seeded._harvest(seeded._device_phase(rows))
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x._tokens, y._tokens)
        assert x.info.language == y.info.language


def test_real_weights_require_a_vocabulary(tmp_path, monkeypatch, jax_checkpoint):
    monkeypatch.delenv("STT_ALLOW_FALLBACK_TOKENIZER", raising=False)
    with pytest.raises(FileNotFoundError, match="STT_ALLOW_FALLBACK_TOKENIZER"):
        load_tokenizer(str(tmp_path), CONFIG.n_vocab, require_real=True)
    with pytest.raises(FileNotFoundError, match="tokenizer vocab"):
        TE.WhisperEngine("test", device="cpu", compute_type="float32",
                         weights_path=jax_checkpoint)
    assert isinstance(load_tokenizer(str(tmp_path), CONFIG.n_vocab), FallbackTokenizer)
    monkeypatch.setenv("STT_ALLOW_FALLBACK_TOKENIZER", "1")
    assert isinstance(load_tokenizer(str(tmp_path), CONFIG.n_vocab, require_real=True),
                      FallbackTokenizer)


def test_missing_checkpoint_names_the_file(tmp_path):
    with pytest.raises(FileNotFoundError, match="config.json"):
        TE.WhisperEngine("test", device="cpu", compute_type="float32",
                         weights_path=str(tmp_path / "nothing"))

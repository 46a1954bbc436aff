"""Architecture ``whisper``: the port's encoder-decoder Whisper models,
served by ``stt_tpu_torch.engine.engine.WhisperEngine``.

What the harness knows of this family, under the names that
``benchmark/core/manifest.py`` gives every architecture module: the CPU
rehearsal's sizes, the engine, the check that it runs what the
configuration states, the FLOPs of a served request, and the judge.

The judge runs a sample of the window's finished requests through the
plain float32 reference (``benchmark/reference/whisper.py``) over each
request's prompt and served tokens. At every served position:

- a greedy token is judged by how far its reference logit lies below the
  reference's best allowed token (``token_gap``); every cell decodes
  greedily, and a request of a beam search is refused;
- the prompt must be the reference's own, and no served token may be one
  the decoding rules forbid at its position (``forbidden``: suppressed
  specials, a blank or end-of-text first);
- the log-probability the program reports for the whole sequence is held
  to the reference's sum over the same tokens (``logprob_err``, per token;
  the widest row, and ``logprob_err_med``, the median row);
- the program's p(no_speech), read from the logits at the start-of-text
  position before any token is decoded, is held to the reference's, as a
  difference of logarithms (``no_speech_err``, the widest row, and
  ``no_speech_err_med``, the median row): the front end, the encoder
  and the cross K/V reach every decoded token through it, and with random
  weights and this audio a greedy token's lead over the next is wide, so
  the token gaps alone would hardly see the precision they run at.

A request that raised counts in ``errors``.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from benchmark.core.flops import FRAMES_PER_SEC
from benchmark.core.records import Req, Run
from benchmark.reference import whisper as R

# the CPU rehearsal's model and engine: the port's ``test`` widths, two rungs
REHEARSAL = {"model_size": "test", "d_model": 64, "encoder_layers": 2, "decoder_layers": 2,
             "encoder_attention_heads": 2, "decoder_attention_heads": 2}
REHEARSAL_ENGINE = {"batch_buckets": [1, 4], "max_batch": 4}


def build_engine(config: Dict, seed: int, device: str, recorder):
    """The port's batching engine with the configuration's settings, its
    weights drawn from ``seed``, and ``recorder`` as its metrics hook."""
    from stt_tpu_torch.engine.engine import WhisperEngine

    eng = config["engine"]
    return WhisperEngine(
        config["model_size"], device, config["compute_type"],
        audio_buckets_sec=eng["audio_buckets_sec"], batch_buckets=eng["batch_buckets"],
        max_decode_tokens=eng["max_decode_tokens"], batch_window_ms=eng["batch_window_ms"],
        max_batch=eng["max_batch"], draft_mode=eng["draft_mode"], seed=seed,
        cross_kv_dtype=eng["cross_kv_dtype"], xattn_kernel=eng["xattn_kernel"],
        flash_attention=eng["flash_attention"], audio_wire=eng["audio_wire"],
        pipeline_depth=eng["pipeline_depth"], use_pallas=eng["use_pallas"],
        metrics=recorder,
    )


def check_deployment(engine, config: Dict) -> None:
    """The engine runs what the configuration states, or the run stops."""
    from stt_tpu_torch.models.presets import get_config

    want = config["engine"]
    pol, dec = engine.policy, engine.decoder_policy
    preset = get_config(config["model_size"])
    found = {
        "d_model": preset.n_audio_state, "encoder_layers": preset.n_audio_layer,
        "decoder_layers": preset.n_text_layer, "encoder_attention_heads": preset.n_audio_head,
        "decoder_attention_heads": preset.n_text_head, "num_mel_bins": preset.n_mels,
        "vocab_size": preset.n_vocab, "max_source_positions": preset.n_audio_ctx,
        "max_target_positions": preset.n_text_ctx,
    }
    wrong = {k: (v, config[k]) for k, v in found.items() if config[k] != v}
    stated = {"cross_kv_dtype": pol.cross_kv_dtype, "xattn_kernel": pol.xattn_kernel,
              "flash_attention": pol.flash_attention, "audio_wire": engine.audio_wire,
              "pipeline_depth": engine.pipeline_depth}
    wrong.update({k: (v, want[k]) for k, v in stated.items() if v != want[k]})
    policy = {"weights": "bf16", "fused_qkv": False, "self_kv": "bf16",
              "prefill": "parallel"}
    wrong.update({f"decoder_policy.{k}": (getattr(dec, k), v) for k, v in policy.items()
                  if getattr(dec, k) != v})
    if wrong:
        raise SystemExit(f"the engine departs from the configuration (found, stated): {wrong}")


def flops(config: Dict, bucket_sec: float, p_len: int, gen_tokens: int,
          beams: int = 1) -> float:
    """Matrix-product FLOPs of one request: the encoder over its padded
    bucket, the cross K/V, then ``p_len + gen_tokens`` decoder steps with a
    KV cache, each for every one of ``beams`` beams. The encoder and cross
    K/V run once a row, whatever the beam. A copy of the port's bench
    formula (``whisper_request_flops``) with the beams added."""
    d = int(config["d_model"])
    n_mels = int(config["num_mel_bins"])
    ta = int(bucket_sec * FRAMES_PER_SEC) // 2
    t_mel = int(bucket_sec * FRAMES_PER_SEC)
    flops = 2 * 3 * n_mels * d * t_mel
    flops += 2 * 3 * d * d * (t_mel // 2)
    flops += int(config["encoder_layers"]) * (
        2 * 4 * ta * d * d + 2 * 2 * ta * ta * d + 2 * 8 * ta * d * d)
    layers = int(config["decoder_layers"])
    flops += layers * 2 * 2 * ta * d * d
    steps = p_len + gen_tokens
    per_step = layers * (
        2 * 4 * d * d + 2 * 2 * d * d + 2 * 8 * d * d
        + 2 * 2 * steps * d + 2 * 2 * ta * d
    ) + 2 * d * int(config["vocab_size"])
    flops += steps * per_step * beams
    return float(flops)


def _produced(out) -> int:
    """Tokens a row produced: its text, and the end-of-text if it stopped."""
    ended = out._p_len + out._n_gen < len(out._tokens)
    return int(out._n_gen) + int(ended)


def request_flops(config: Dict, run: Run, req: Req) -> float:
    """:func:`flops` of a finished request, at the bucket the configuration
    serves it in, with its prompt, the tokens it produced and its beams."""
    return flops(config, run.bucket_of(req), int(req.output._p_len), _produced(req.output),
                 req.beams)


def judge(run: Run, reqs: List[Req], weights_seed: int, device,
          control: bool = False) -> Dict[str, float]:
    """The compared numbers over ``reqs`` (see the module docstring), with
    the weights drawn again from ``weights_seed``, and the count of tokens
    judged. With ``control`` the reference computed in
    fp8 stands in the program's place over the same prompts and served
    tokens: at each position the token it puts first is judged, and its
    sums of log-probabilities and p(no_speech) are held to float32's."""
    config = run.config
    dims = R.dims_of(config)
    wire = config["engine"]["audio_wire"]
    R.exact_float32()
    weights = R.draw_weights(dims, weights_seed, device)
    suppress = R.suppress_mask(dims.n_vocab, device)
    begin = R.begin_mask(dims.n_vocab, device)
    no_speech = R.layout_of(dims.n_vocab).no_speech
    gap, forbidden, judged = 0.0, 0, 0
    lp_errs, ns_errs = [], []

    with torch.inference_mode():
        for req in reqs:
            if req.beams != 1:
                raise ValueError("the check judges greedy requests only")
            out = req.output
            prompt = R.prompt_of(dims.n_vocab, req.language)
            row = [int(t) for t in out._tokens]
            p_len, n_gen = int(out._p_len), int(out._n_gen)
            forbidden += sum(a != b for a, b in zip(row[:p_len], prompt))
            forbidden += abs(p_len - len(prompt))
            seq = prompt + row[p_len: p_len + n_gen]
            if p_len + n_gen < len(row):
                seq.append(row[p_len + n_gen])   # the end-of-text that ended it
            if len(seq) == len(prompt):
                continue
            args = (weights, dims, req.audio, run.bucket_of(req), wire, seq, device)
            logits = R.request_logits(*args)
            at = torch.arange(len(prompt) - 1, len(seq) - 1, device=device)
            masked = logits[at] + suppress
            masked[0] += begin
            served = torch.tensor(seq[len(prompt):], device=device)
            ref_lp = torch.log_softmax(masked, dim=1)
            ref_ns = float(torch.log_softmax(logits[0], dim=0)[no_speech])
            if control:
                low = R.request_logits(*args, lowp=R.to_fp8)
                low_masked = low[at] + suppress
                low_masked[0] += begin
                picked = low_masked.argmax(dim=1)
                got_sum = float(torch.log_softmax(low_masked, dim=1)
                                .gather(1, served[:, None]).sum())
                got_ns = float(torch.log_softmax(low[0], dim=0)[no_speech])
            else:
                picked = served
                got_sum = float(out.avg_logprob) * max(1, n_gen)
                got_ns = float(np.log(max(out.no_speech_prob, 1e-30)))
            chosen = masked.gather(1, picked[:, None])[:, 0]
            banned = torch.isinf(chosen)
            forbidden += int(banned.sum())
            best = masked.amax(dim=1)
            gap = max(gap, float(torch.where(banned, 0.0, (best - chosen).clamp_min(0.0)).max()))
            ref_sum = float(torch.where(torch.isinf(ref_lp.gather(1, served[:, None])[:, 0]),
                                        0.0, ref_lp.gather(1, served[:, None])[:, 0]).sum())
            lp_errs.append(abs(got_sum - ref_sum) / len(served))
            ns_errs.append(abs(got_ns - ref_ns))
            judged += len(served)
    del weights
    errors = sum(1 for r in run.requests if r.error is not None)
    lp_errs, ns_errs = lp_errs or [0.0], ns_errs or [0.0]
    return {"token_gap": gap, "forbidden": float(forbidden),
            "logprob_err": max(lp_errs), "logprob_err_med": float(np.median(lp_errs)),
            "no_speech_err": max(ns_errs), "no_speech_err_med": float(np.median(ns_errs)),
            "errors": float(errors), "tokens_judged": float(judged),
            "requests_judged": float(len(reqs))}

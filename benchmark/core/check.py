"""Whether what the timed path served is correct.

Once the window has closed and the program's state is freed, a sample of
the requests the window finished, drawn from the seed with the longest
among them, is run through the plain float32 reference
(``benchmark/reference/whisper.py``) over each request's prompt and served
tokens. At every served position:

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

A request that raised counts in ``errors``. Each number has its limit in
the cell's traffic file (``limits``), set from readings of the
program and of a control in lower precision; the run is correct when no
number passes its limit.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..reference import whisper as R
from .records import Req, Run

SAMPLE = 16     # requests judged a run
LONGEST = 2     # of them, those with the most served tokens


def sample(run: Run, seed: int) -> List[Req]:
    """``LONGEST`` of the window's finished requests with the most served
    tokens, then others drawn from the seed, ``SAMPLE`` in all."""
    size, longest = SAMPLE, LONGEST
    done = [r for r in run.counted() if r.ok]
    done.sort(key=lambda r: (-r.output._n_gen, r.due))
    picked, rest = done[:longest], done[longest:]
    rng = np.random.default_rng([int(seed), 2])
    extra = rng.choice(len(rest), size=min(size - len(picked), len(rest)), replace=False)
    return picked + [rest[i] for i in sorted(extra)]


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

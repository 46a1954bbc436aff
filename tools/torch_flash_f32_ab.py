#!/usr/bin/env python3
"""Time one checkout's float32 flash-attention body at the served shapes.

    python3 tools/torch_flash_f32_ab.py --tree DIR [--tag NAME]

Imports ``stt_tpu_torch`` from DIR (a checkout of the repository, for
example an older commit unpacked with ``git archive``), builds its
``flash_attention.cu`` there, and times its float32 body through its own
wrapper at 1, 4, 16 and 64 rows x 12 heads x 1500 positions x Dh 64 (the
float32 path's 30 s bucket at each row bucket), next to
``scaled_dot_product_attention`` in float32 on the same inputs, with the
cold timer of this repository's ``chip_smoke.py`` (L2 flushed, the device
spinning until the call is enqueued). TF32 is off. Prints the card's name
and power limit, then one JSON line per shape.

To compare two versions, run it for each tree in turn, parent, change,
change, parent, in one command on one card. Needs a CUDA card and nvcc.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SHAPES = [(1, 12, 1500, 64), (4, 12, 1500, 64), (16, 12, 1500, 64), (64, 12, 1500, 64)]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", required=True, type=Path,
                    help="checkout whose stt_tpu_torch is timed")
    ap.add_argument("--tag", default=None, help="name printed with each line")
    args = ap.parse_args()
    tree = args.tree.resolve()
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as C  # the timer and the card's name, from this checkout

    sys.path.insert(0, str(tree))
    import stt_tpu_torch
    from stt_tpu_torch.ops.kernels.flash_attention import flash_attention, flash_attention_plain

    if Path(stt_tpu_torch.__file__).resolve().parent.parent != tree:
        sys.exit(f"stt_tpu_torch came from {stt_tpu_torch.__file__}, not from {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    F = torch.nn.functional
    dev = torch.device("cuda", 0)
    print(C.gpu_name_and_power(), flush=True)
    for b, h, t, dh in SHAPES:
        gen = torch.Generator(device=dev).manual_seed(b * 10000 + t + dh)
        scale = dh ** -0.25
        q, k, v = (torch.randn((b, h, t, dh), generator=gen, device=dev) * sc
                   for sc in (scale, scale, 1.0))
        got = flash_attention(q, k, v)
        err = None
        if b <= 16:  # the plain version's logits reach 6.9 GB at 64 rows
            err = (got - flash_attention_plain(q, k, v)).abs().max().item()
        k_ms = C.cuda_ms_cold(torch, lambda: flash_attention(q, k, v))
        l_ms = C.cuda_ms_cold(torch, lambda: F.scaled_dot_product_attention(q, k, v, scale=1.0),
                              iters=5 if b > 16 else 20)
        b_ms, _ = C.bound(4 * q.numel() * 4, 4.0 * b * h * t * t * dh, C.H100_F32_FLOPS)
        print(json.dumps({"tag": args.tag or str(tree), "rows": b, "heads": h, "t": t, "dh": dh,
                          "ms": k_ms, "sdpa_ms": l_ms, "bound_ms": b_ms,
                          "max_abs_err_vs_plain": err}), flush=True)


if __name__ == "__main__":
    main()

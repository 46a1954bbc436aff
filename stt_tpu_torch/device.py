"""Device resolution for the port's entry points.

Counterpart of ``stt_tpu/engine/engine.py::_resolve_device``. The port
runs on the card by default: ``None`` (or ``"cuda"``) means the
CUDA device, and the CPU is used only when the caller asks for it with
``"cpu"``. A request for the card on a host without CUDA raises; it never
falls back to the CPU, so a run that meant to measure the card cannot
quietly measure the host.
"""

from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """Map a device name onto a ``torch.device``.

    Accepts ``None``, ``"cuda"``, ``"cuda:N"``, ``"cpu"`` or a
    ``torch.device``. Raises ``RuntimeError`` when a CUDA device is asked
    for (explicitly or by default) and ``torch.cuda.is_available()`` is
    false, and ``ValueError`` for any other name.
    """
    if isinstance(device, torch.device):
        name = str(device)
    else:
        name = (device or "cuda").strip().lower()
    if name == "cpu":
        return torch.device("cpu")
    base, _, index = name.partition(":")
    if base != "cuda":
        raise ValueError(f"unknown device {device!r} (use 'cuda' or 'cpu')")
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} needs CUDA, but torch.cuda.is_available() "
            f"is false; pass device='cpu' to run on the host"
        )
    return torch.device("cuda", int(index) if index else torch.cuda.current_device())


__all__ = ["resolve_device"]

"""Backend registry: name -> ModelBackend class with lazy imports.

Counterpart of ``stt_tpu/backends/__init__.py``. ``torch_whisper`` is the
port's backend, on the card; ``fake`` is the hermetic test/dev backend (own
copy of the JAX package's). The other Whisper backend names the shipped
configs use (``jax_whisper`` first of all) alias to ``torch_whisper``, as
the JAX package aliases the reference's names onto its own backend, so
the same YAML files boot either server.
"""

from __future__ import annotations

from typing import Type

from .base import BackendInfo, ModelBackend, Segment  # noqa: F401

_ALIASES = {
    "torch_whisper": "torch_whisper",
    # names of the JAX package and the reference, accepted for config compatibility
    "jax_whisper": "torch_whisper",
    "jax": "torch_whisper",
    "whisper_jax": "torch_whisper",
    "faster_whisper": "torch_whisper",
    "mlx_whisper": "torch_whisper",
    "fake": "fake",
    "test": "fake",
}


def get_backend(name: str) -> Type:
    key = _ALIASES.get((name or "").lower())
    if key == "torch_whisper":
        from .torch_whisper import TorchWhisperBackend

        return TorchWhisperBackend
    if key == "fake":
        from .fake import FakeBackend

        return FakeBackend
    raise ValueError(f"unknown model backend: {name!r}")


__all__ = ["BackendInfo", "ModelBackend", "Segment", "get_backend"]

"""PyTorch/CUDA port of :mod:`stt_tpu` for one NVIDIA H100.

The package mirrors ``stt_tpu``'s module layout (``models/``, ``ops/``,
``engine/``, ``backends/``, ``server/``, ``config/``, ``gen/``, ``utils/``)
so each port module sits where its JAX counterpart does; the JAX-free
ones are own copies. It imports ``torch`` and never ``jax`` or ``stt_tpu``;
entry points run on the card unless the caller asks for the CPU.
"""

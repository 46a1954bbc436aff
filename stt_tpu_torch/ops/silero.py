"""Learned Silero-class VAD from a local ONNX file, executed with torch.

Counterpart of ``stt_tpu/ops/silero.py`` for the port, which imports
nothing of ``stt_tpu``. The reference endpoints on Silero-VAD probabilities
over 512-sample/32 ms frames, loading the model from the silero package's
ONNX export (``stt_server/backend/component/vad_gate.py:235-394``). Here
the graph is parsed and executed by the port's own executor
(:mod:`stt_tpu_torch.ops.onnx_torch`) on an explicit device (the card unless
the caller asks for the CPU), so a deployment that HAS the Silero ONNX file
gets the learned scorer with no extra runtime dependency; the zero-egress
default stays the DSP VAD.

Signature handling is generic over the two published Silero exports:
- v5: inputs ``(input[B, 576], state[2, B, 128], sr)`` — the 576 window is
  64 context samples + the 512 frame; one ``state`` tensor.
- v4: inputs ``(input[B, W], h[2, B, 64], c[2, B, 64], sr)`` — two state
  tensors, no context prefix.
Anything shaped like these (audio input + zero or more state tensors + an
optional sr scalar) loads; state tensors round-trip between calls and live
on the device. The sample rate goes in as a host constant, so the graph's
``If`` on it folds on the host.

Threshold note: Silero probabilities and the DSP VAD's are calibrated
differently — both default to 0.5, but tuned ``vad_threshold`` values
should be re-validated when switching scorers.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .onnx_torch import OnnxGraph, load_onnx_graph, run_graph
from .vad import VAD_FRAME_SAMPLES, VAD_SAMPLE_RATE

_STATE_HINTS = ("state", "h", "c", "hn", "cn", "h0", "c0")


class SileroVad:
    """A loaded Silero-class ONNX VAD: ``score(window, states)`` a call."""

    @classmethod
    def from_onnx(cls, path: str, sample_rate: int = VAD_SAMPLE_RATE,
                  device=None) -> "SileroVad":
        return cls(load_onnx_graph(path), sample_rate, device)

    def __init__(self, graph: OnnxGraph, sample_rate: int = VAD_SAMPLE_RATE,
                 device=None) -> None:
        self.graph = graph
        self.sample_rate = sample_rate
        self.device = resolve_device(device)
        names = list(graph.inputs)
        if not names:
            raise ValueError("ONNX graph has no inputs")
        self.input_name = names[0]
        self.sr_name: Optional[str] = None
        self.state_names: List[str] = []
        for name in names[1:]:
            shape = graph.input_shapes.get(name) or []
            low = name.lower()
            if low in ("sr", "sample_rate") or (len(shape) == 0 and low not in _STATE_HINTS):
                self.sr_name = name
            else:
                self.state_names.append(name)
        # context length: declared input window minus the 512 frame (v5
        # exports input as [B, 576] -> 64 context samples)
        in_shape = graph.input_shapes.get(self.input_name) or []
        window = in_shape[-1] if in_shape and in_shape[-1] else None
        self.context_samples = max(0, int(window) - VAD_FRAME_SAMPLES) if window else 0

    def forward(self, audio: torch.Tensor, *states: torch.Tensor):
        """audio (B, W) and the state tensors on the device -> (prob
        tensor, new state tensors), nothing read back."""
        env = {self.input_name: audio}
        if self.sr_name:
            env[self.sr_name] = np.int64(self.sample_rate)
        for name, st in zip(self.state_names, states):
            env[name] = st
        with torch.inference_mode():
            outs = run_graph(self.graph, env, self.device)
        return outs[0], tuple(outs[1:1 + len(self.state_names)])

    def init_state(self, batch: int = 1) -> Tuple[torch.Tensor, ...]:
        states = []
        for name in self.state_names:
            shape = [(batch if d is None or d == 0 else int(d))
                     for d in (self.graph.input_shapes.get(name) or [batch])]
            states.append(torch.zeros(shape, dtype=torch.float32, device=self.device))
        return tuple(states)

    def score(self, window: np.ndarray,
              states: Tuple[torch.Tensor, ...]) -> Tuple[float, Tuple[torch.Tensor, ...]]:
        """window (1, context+512) float32 -> (speech prob, new states): one
        copy to the device and one read of the probability."""
        audio = torch.from_numpy(np.ascontiguousarray(window, np.float32)).to(self.device)
        prob, new_states = self.forward(audio, *states)
        prob = prob if torch.is_tensor(prob) else torch.as_tensor(prob)
        return float(prob.reshape(-1)[0]), new_states


class SileroVadSession:
    """Per-stream adapter with the :class:`VadSession` interface:
    ``score(frames (F, 512)) -> probs (F,)`` plus ``reset()``. Carries the
    recurrent state (on the device) and the context tail between chunks."""

    def __init__(self, model: SileroVad) -> None:
        self._model = model
        self.reset()

    def reset(self) -> None:
        self._states = self._model.init_state(1)
        self._context = np.zeros(self._model.context_samples, np.float32)

    def score(self, frames: np.ndarray) -> np.ndarray:
        probs = np.zeros(frames.shape[0], np.float32)
        ctx_n = self._model.context_samples
        for i in range(frames.shape[0]):
            frame = frames[i].astype(np.float32)
            window = np.concatenate([self._context, frame]) if ctx_n else frame
            prob, self._states = self._model.score(window[None, :], self._states)
            probs[i] = prob
            if ctx_n:
                self._context = frame[-ctx_n:]
        return probs


def load_silero(path: str, sample_rate: int = VAD_SAMPLE_RATE, device=None) -> SileroVad:
    return SileroVad.from_onnx(path, sample_rate, device)


__all__ = ["SileroVad", "SileroVadSession", "load_silero"]

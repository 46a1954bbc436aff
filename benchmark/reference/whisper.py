"""Plain float32 Whisper: the benchmark's reference for what a served request
should have produced.

Written from the published model (openai-whisper's ``model.py`` and
``audio.py``) and from the deployment the configuration file states. It
imports nothing of the program under test and takes nothing it made: the
weights are drawn again here from the run's seed, the audio is sent over
the wire again, and the mel, the encoder states, the int8 cross K/V with
its scales and the prompt are all worked out again.

- Weights: :func:`draw_weights` is a frozen copy of the seeded draw the
  program's engine makes from its ``seed`` option (numpy's
  ``default_rng(seed)``, normal leaves in a fixed order, each drawn in
  float64 and rounded once to float32; biases and layer-norm offsets zero,
  gains one, so the reference leaves them out; sinusoidal audio
  positions). Linear weights are (d_in, d_out).
- Wire: 16-bit PCM (``audio * 32768`` clipped, truncated), then 8-bit mu-law
  (mu 255) and back, as the deployment ships audio to the card.
- Front end: centred Hann STFT (n_fft 400, hop 160, reflect padding, last
  frame dropped), power, Slaney mel filterbank, ``log10`` clamped at 1e-10,
  per-row ``max - 8`` floor, ``(x + 4) / 4``. The frames cover the whole
  audio bucket the request is served in, its padding included.
- Encoder, decoder: pre-norm blocks, layer-norm eps 1e-5, exact GELU,
  q and k each scaled by ``d_head ** -0.25``, tied token table for the
  logits; positions cut to the bucket's frames.
- Cross K/V as stored: int8 with one scale per (layer, row, head) over
  (positions, d_head), ``max|x| / 127`` floored at 1e-12, codes rounded
  half to even; the decoder reads ``codes * scale``.

Everything runs in float32 with TF32 off (:func:`exact_float32`). With
``lowp=to_fp8`` every product's two operands are first rounded to fp8
e4m3 (one scale a tensor): the reference computed in the precision below
the deployment's bf16, which is the benchmark's control.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP = 160
BLANK = 220  # the byte-level BPE id of " "


@dataclass(frozen=True)
class Dims:
    n_mels: int
    d_audio: int
    h_audio: int
    l_audio: int
    n_vocab: int
    d_text: int
    h_text: int
    l_text: int
    n_audio_ctx: int
    n_text_ctx: int


def dims_of(config: Dict) -> Dims:
    """Widths from a configuration file, in the published config's names."""
    return Dims(
        n_mels=int(config["num_mel_bins"]), d_audio=int(config["d_model"]),
        h_audio=int(config["encoder_attention_heads"]), l_audio=int(config["encoder_layers"]),
        n_vocab=int(config["vocab_size"]), d_text=int(config["d_model"]),
        h_text=int(config["decoder_attention_heads"]), l_text=int(config["decoder_layers"]),
        n_audio_ctx=int(config["max_source_positions"]),
        n_text_ctx=int(config["max_target_positions"]),
    )


def exact_float32() -> None:
    """Products in full float32: no TF32 in matmuls or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


# ---------------------------------------------------------------------------
# Token layout and prompt
# ---------------------------------------------------------------------------

LANGS = ["en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl", "ca", "nl", "ar"]


@dataclass(frozen=True)
class Layout:
    eot: int
    sot: int
    lang_begin: int
    transcribe: int
    no_speech: int
    no_timestamps: int


def layout_of(n_vocab: int) -> Layout:
    """Special ids of a Whisper vocabulary: the GPT-2 BPE's 50257 text
    tokens, then eot, sot, the languages (100 in the 51866-token
    vocabulary, 99 before it), translate, transcribe, sot_lm, sot_prev,
    no_speech, no_timestamps, then the timestamps."""
    eot = 50257
    n_langs = 100 if n_vocab >= 51866 else 99
    translate = eot + 2 + n_langs
    return Layout(eot=eot, sot=eot + 1, lang_begin=eot + 2, transcribe=translate + 1,
                  no_speech=translate + 4, no_timestamps=translate + 5)


def prompt_of(n_vocab: int, language: str) -> List[int]:
    """``[sot, language, transcribe, no_timestamps]``."""
    lay = layout_of(n_vocab)
    return [lay.sot, lay.lang_begin + LANGS.index(language), lay.transcribe, lay.no_timestamps]


def suppress_mask(n_vocab: int, device) -> torch.Tensor:
    """Without timestamps every special token but eot is suppressed."""
    lay = layout_of(n_vocab)
    mask = torch.zeros(n_vocab, device=device)
    mask[lay.sot:] = -torch.inf
    mask[lay.eot] = 0.0
    return mask


def begin_mask(n_vocab: int, device) -> torch.Tensor:
    """At the first generated position: no lone blank and no eot."""
    mask = torch.zeros(n_vocab, device=device)
    mask[BLANK] = -torch.inf
    mask[layout_of(n_vocab).eot] = -torch.inf
    return mask


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def _sinusoids(length: int, channels: int) -> np.ndarray:
    log_timescale = math.log(10000.0) / (channels // 2 - 1)
    inv = np.exp(-log_timescale * np.arange(channels // 2))
    scaled = np.arange(length)[:, None] * inv[None, :]
    return np.concatenate([np.sin(scaled), np.cos(scaled)], axis=1).astype(np.float32)


def draw_weights(dims: Dims, seed: int, device) -> Dict[str, torch.Tensor]:
    """The seeded draw, leaf by leaf in its fixed order, each leaf moved to
    ``device`` as float32 as soon as it is drawn. Keys are flat:
    ``enc.3.attn.q.w``, ``dec.tok``, ..."""
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}

    def put(key: str, arr: np.ndarray) -> None:
        out[key] = torch.from_numpy(np.ascontiguousarray(arr, dtype=np.float32)).to(device)

    def normal(key: str, std: float, shape) -> None:
        put(key, rng.normal(0.0, std, shape).astype(np.float32))

    def block(prefix: str, d: int, cross: bool) -> None:
        for lin in ("q", "k", "v", "o"):
            normal(f"{prefix}.attn.{lin}.w", d ** -0.5, (d, d))
        normal(f"{prefix}.mlp.fc1.w", d ** -0.5, (d, 4 * d))
        normal(f"{prefix}.mlp.fc2.w", (4 * d) ** -0.5, (4 * d, d))
        if cross:
            for lin in ("q", "k", "v", "o"):
                normal(f"{prefix}.xattn.{lin}.w", d ** -0.5, (d, d))

    da, dt = dims.d_audio, dims.d_text
    normal("enc.conv1.w", (3 * dims.n_mels) ** -0.5, (3, dims.n_mels, da))
    normal("enc.conv2.w", (3 * da) ** -0.5, (3, da, da))
    put("enc.pos", _sinusoids(dims.n_audio_ctx, da))
    for li in range(dims.l_audio):
        block(f"enc.{li}", da, cross=False)
    normal("dec.tok", 0.02, (dims.n_vocab, dt))
    normal("dec.pos", 0.01, (dims.n_text_ctx, dt))
    for li in range(dims.l_text):
        block(f"dec.{li}", dt, cross=True)
    return out


# ---------------------------------------------------------------------------
# Wire and front end
# ---------------------------------------------------------------------------


def pcm16(audio: np.ndarray) -> np.ndarray:
    """float32 audio -> 16-bit PCM: ``audio * 32768`` clipped, truncated."""
    return np.clip(audio * 32768.0, -32768, 32767).astype(np.int16)


def mulaw_roundtrip(pcm: np.ndarray) -> np.ndarray:
    """16-bit PCM -> 8-bit mu-law codes -> float32 audio, in float32
    arithmetic: ``y = sign(x) log(1 + 255|x|) / log(256)``, code
    ``round((y + 1) * 127.5)``; back, ``sign(y) (256^|y| - 1) / 255``."""
    x = pcm.astype(np.float32) / np.float32(32768.0)
    y = (np.sign(x) * np.log1p(np.float32(255.0) * np.abs(x))
         / np.float32(np.log(256.0))).astype(np.float32)
    code = np.round((y + np.float32(1.0)) * np.float32(127.5)).astype(np.uint8)
    z = code.astype(np.float32) * np.float32(1.0 / 127.5) - np.float32(1.0)
    return (np.sign(z) * (np.exp2(np.float32(8.0) * np.abs(z)) - np.float32(1.0))
            * np.float32(1.0 / 255.0)).astype(np.float32)


def served_row(audio: np.ndarray, bucket_sec: float, wire: str) -> np.ndarray:
    """The float32 waveform the card sees for one request: the newest
    ``bucket`` seconds of it (whole hops), zero-padded to the bucket, over
    the wire (``mulaw``, or lossless 16-bit PCM for ``int16``)."""
    n = int(bucket_sec * SAMPLE_RATE)
    n -= n % HOP
    row = np.zeros(n, np.int16)
    tail = audio[-n:] if len(audio) > n else audio
    row[: len(tail)] = pcm16(tail)
    if wire == "mulaw":
        return mulaw_roundtrip(row)
    return row.astype(np.float32) / np.float32(32768.0)


def mel_filters(n_mels: int) -> np.ndarray:
    """Slaney-scale, Slaney-normalised filterbank (n_mels, 201), as
    librosa's ``filters.mel`` defaults build it."""
    def hz_to_mel(f):
        f = np.asarray(f, np.float64)
        return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                        / (np.log(6.4) / 27.0), f / (200.0 / 3.0))

    def mel_to_hz(m):
        m = np.asarray(m, np.float64)
        return np.where(m >= 15.0, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)),
                        m * (200.0 / 3.0))

    freqs = np.linspace(0.0, SAMPLE_RATE / 2.0, N_FFT // 2 + 1)
    pts = mel_to_hz(np.linspace(hz_to_mel(0.0), hz_to_mel(SAMPLE_RATE / 2.0), n_mels + 2))
    fdiff = np.diff(pts)
    ramps = pts[:, None] - freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights *= (2.0 / (pts[2:n_mels + 2] - pts[:n_mels]))[:, None]
    return weights.astype(np.float32)


def log_mel(wave: torch.Tensor, n_mels: int) -> torch.Tensor:
    """float32 waveform (B, T), T a multiple of the hop -> normalised
    log-mel (B, n_mels, T // hop)."""
    n_frames = wave.shape[1] // HOP
    padded = F.pad(wave[:, None, :], (N_FFT // 2, N_FFT // 2), mode="reflect")[:, 0]
    frames = padded.unfold(-1, N_FFT, HOP)[:, :n_frames]
    n = torch.arange(N_FFT, device=wave.device, dtype=torch.float64)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * n / N_FFT)).to(torch.float32)
    spec = torch.fft.rfft(frames * window, dim=-1)
    power = spec.real ** 2 + spec.imag ** 2
    fb = torch.from_numpy(mel_filters(n_mels)).to(wave.device)
    mel = torch.clamp_min(power @ fb.T, 1e-10).log10().transpose(1, 2)
    mel = torch.maximum(mel, mel.amax(dim=(1, 2), keepdim=True) - 8.0)
    return (mel + 4.0) / 4.0


# ---------------------------------------------------------------------------
# Transformer
# ---------------------------------------------------------------------------


def to_fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to fp8 e4m3 under one scale for the tensor (its largest
    magnitude to 448, the format's largest), back in float32."""
    scale = x.abs().amax().clamp_min(1e-30) / 448.0
    return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale


def _mm(a: torch.Tensor, b: torch.Tensor, lowp=None) -> torch.Tensor:
    """A product, its operands first rounded by ``lowp`` when given."""
    if lowp is not None:
        a, b = lowp(a), lowp(b)
    return a @ b


def _ln(x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, (x.shape[-1],), eps=1e-5)


def _heads(x: torch.Tensor, h: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, h, d // h).transpose(1, 2)


def _merge(x: torch.Tensor) -> torch.Tensor:
    b, h, t, dh = x.shape
    return x.transpose(1, 2).reshape(b, t, h * dh)


def _attend(q, k, v, h: int, causal: bool = False, lowp=None) -> torch.Tensor:
    """q (B, Tq, d); k, v already head-split (B, H, Tk, Dh), k scaled."""
    scale = (q.shape[-1] // h) ** -0.25
    s = _mm(_heads(q, h) * scale, k.transpose(-1, -2), lowp)
    if causal:
        tq, tk = s.shape[-2:]
        s = s.masked_fill(torch.ones(tq, tk, dtype=torch.bool, device=s.device)
                          .triu(1), -torch.inf)
    return _merge(_mm(torch.softmax(s, dim=-1), v, lowp))


def _self_attention(w, p: str, x: torch.Tensor, h: int, causal: bool,
                    lowp=None) -> torch.Tensor:
    scale = (x.shape[-1] // h) ** -0.25
    k = _heads(_mm(x, w[f"{p}.attn.k.w"], lowp), h) * scale
    v = _heads(_mm(x, w[f"{p}.attn.v.w"], lowp), h)
    out = _attend(_mm(x, w[f"{p}.attn.q.w"], lowp), k, v, h, causal, lowp)
    return _mm(out, w[f"{p}.attn.o.w"], lowp)


def _mlp(w, p: str, x: torch.Tensor, lowp=None) -> torch.Tensor:
    return _mm(F.gelu(_mm(x, w[f"{p}.mlp.fc1.w"], lowp)), w[f"{p}.mlp.fc2.w"], lowp)


def _conv(x: torch.Tensor, kernel: torch.Tensor, stride: int, lowp=None) -> torch.Tensor:
    if lowp is not None:
        x, kernel = lowp(x), lowp(kernel)
    return F.conv1d(x, kernel.permute(2, 1, 0), stride=stride, padding=1)


def encode(w: Dict[str, torch.Tensor], dims: Dims, mel: torch.Tensor,
           lowp=None) -> torch.Tensor:
    """Normalised log-mel (B, n_mels, F) -> encoder states (B, F // 2, d)."""
    x = F.gelu(_conv(mel, w["enc.conv1.w"], 1, lowp))
    x = F.gelu(_conv(x, w["enc.conv2.w"], 2, lowp))
    x = x.transpose(1, 2)
    x = x + w["enc.pos"][: x.shape[1]]
    for li in range(dims.l_audio):
        p = f"enc.{li}"
        x = x + _self_attention(w, p, _ln(x), dims.h_audio, False, lowp)
        x = x + _mlp(w, p, _ln(x), lowp)
    return _ln(x)


def cross_kv_int8(w: Dict[str, torch.Tensor], dims: Dims, enc: torch.Tensor,
                  lowp=None) -> List[tuple]:
    """Each decoder layer's cross K/V as the deployment stores it: int8
    codes with one scale per (row, head), read back as codes * scale."""
    h = dims.h_text
    scale = (enc.shape[-1] // h) ** -0.25
    out = []
    for li in range(dims.l_text):
        p = f"dec.{li}.xattn"
        pair = []
        for x in (_heads(_mm(enc, w[f"{p}.k.w"], lowp), h) * scale,
                  _heads(_mm(enc, w[f"{p}.v.w"], lowp), h)):
            s = torch.clamp_min(x.abs().amax(dim=(2, 3), keepdim=True) / 127.0, 1e-12)
            pair.append(torch.round(x / s) * s)
        out.append(tuple(pair))
    return out


def decoder_logits(w: Dict[str, torch.Tensor], dims: Dims, tokens: torch.Tensor,
                   cross: List[tuple], lowp=None) -> torch.Tensor:
    """Teacher-forced decoder: tokens (B, T) -> float32 logits (B, T, V),
    row t predicting token t + 1."""
    t = tokens.shape[1]
    x = w["dec.tok"][tokens] + w["dec.pos"][:t]
    for li in range(dims.l_text):
        p = f"dec.{li}"
        x = x + _self_attention(w, p, _ln(x), dims.h_text, True, lowp)
        ck, cv = cross[li]
        q = _mm(_ln(x), w[f"{p}.xattn.q.w"], lowp)
        x = x + _mm(_attend(q, ck, cv, dims.h_text, False, lowp), w[f"{p}.xattn.o.w"], lowp)
        x = x + _mlp(w, p, _ln(x), lowp)
    return _mm(_ln(x), w["dec.tok"].T, lowp)


def request_logits(w: Dict[str, torch.Tensor], dims: Dims, audio: np.ndarray,
                   bucket_sec: float, wire: str, tokens: List[int],
                   device, lowp=None) -> torch.Tensor:
    """The reference's logits over one served request: its audio through the
    wire, the front end and the encoder at its bucket, the int8 cross K/V,
    then the decoder over ``tokens`` (prompt and served tokens). (T, V)."""
    wave = torch.from_numpy(served_row(audio, bucket_sec, wire))[None].to(device)
    enc = encode(w, dims, log_mel(wave, dims.n_mels), lowp)
    cross = cross_kv_int8(w, dims, enc, lowp)
    ids = torch.tensor([tokens], dtype=torch.long, device=device)
    return decoder_logits(w, dims, ids, cross, lowp)[0]


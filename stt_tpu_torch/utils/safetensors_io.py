"""A reader and a writer of the safetensors format, so that the port loads
and writes HF checkpoints on a host without the ``safetensors`` package.

The format: a little-endian u64 header length N, then N bytes of JSON
(``{name: {"dtype", "shape", "data_offsets": [begin, end]}, ...}``, with an
optional ``"__metadata__"`` map of strings), then the raw little-endian
buffers, each at its offsets from the end of the header. The header is
padded with spaces to a multiple of 8 bytes, as the ``safetensors`` package
writes it. F32, F16 and BF16 are handled; a BF16 buffer is read as uint16
bits and viewed as ``torch.bfloat16``.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Mapping

import numpy as np
import torch

# safetensors dtype -> (numpy dtype of the stored bits, torch dtype)
_DTYPES = {
    "F32": (np.dtype("<f4"), torch.float32),
    "F16": (np.dtype("<f2"), torch.float16),
    "BF16": (np.dtype("<u2"), torch.bfloat16),
}
_NAMES = {torch_dtype: name for name, (_, torch_dtype) in _DTYPES.items()}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, as CPU tensors in their stored
    type (each its own copy, the file closed on return)."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        data = np.fromfile(f, dtype=np.uint8)
    out: Dict[str, torch.Tensor] = {}
    for name, entry in header.items():
        if entry["dtype"] not in _DTYPES:
            raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']!r}; "
                             f"only {sorted(_DTYPES)} are read")
        bits, torch_dtype = _DTYPES[entry["dtype"]]
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        count = int(np.prod(shape, dtype=np.int64))
        if end - begin != count * bits.itemsize or end > len(data):
            raise ValueError(f"{path}: tensor {name!r} has offsets {begin}..{end} that do "
                             f"not hold {shape} of {entry['dtype']}")
        arr = data[begin:end].view(bits).reshape(shape).astype(bits.newbyteorder("="))
        tensor = torch.from_numpy(arr)
        if torch_dtype == torch.bfloat16:
            tensor = tensor.view(torch.int16).view(torch.bfloat16)
        out[name] = tensor
    return out


def write_safetensors(path: str, tensors: Mapping[str, torch.Tensor]) -> int:
    """Write ``tensors`` (F32, F16 or BF16, on any device) to ``path`` in the
    safetensors layout, names in sorted order as the ``safetensors`` package
    orders them. Returns the bytes written."""
    header: Dict[str, dict] = {}
    buffers = []
    offset = 0
    for name in sorted(tensors):
        tensor = tensors[name].detach().to("cpu").contiguous()
        if tensor.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {tensor.dtype}; "
                             f"only {sorted(_DTYPES)} are written")
        if tensor.dtype == torch.bfloat16:
            raw = tensor.view(torch.int16).numpy().astype("<i2").tobytes()
        else:
            raw = tensor.numpy().astype(_DTYPES[_NAMES[tensor.dtype]][0]).tobytes()
        header[name] = {"dtype": _NAMES[tensor.dtype], "shape": list(tensor.shape),
                        "data_offsets": [offset, offset + len(raw)]}
        buffers.append(raw)
        offset += len(raw)
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for raw in buffers:
            f.write(raw)
    return 8 + len(blob) + offset


__all__ = ["read_safetensors", "write_safetensors"]

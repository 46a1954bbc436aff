"""Minimal ONNX executor in PyTorch (no onnx/onnxruntime dependency).

Counterpart of ``stt_tpu/ops/onnx_jax.py`` for the port, which imports
nothing of ``stt_tpu``. It loads a LOCAL learned-VAD checkpoint (Silero-VAD
ships as ONNX, reference ``stt_server/backend/component/vad_gate.py:
235-247``) and runs it with torch on an explicit device. Neither ``onnx``
nor ``onnxruntime`` is installed on either host, so this module does both
halves itself:

1. the JAX package's hand-rolled protobuf wire-format reader for the ONNX
   schema subset (ModelProto/GraphProto/NodeProto/TensorProto/
   AttributeProto, field numbers from the public onnx.proto spec), copied
   here line for line, and
2. a graph interpreter over the op set Silero-class models use (Conv,
   LSTM, Gemm/MatMul, elementwise, shape ops, reflection Pad, Slice, If,
   ...), every op the JAX executor has, in torch calls.

Constant folding: values derived only from initializers, attributes and
the constant inputs the caller passes as numpy (Silero's sample rate) stay
numpy on the host and fold there, as the JAX executor folds them at trace
time; an ``If`` whose condition is constant takes its branch on the host,
so Silero's 8k/16k dispatch never reads the card. A numpy value meets a
tensor only inside an op, where it is copied to the tensor's device: the
graph's initializers and ``Constant`` values once per device (kept on the
graph), others at each use.

Held against torch modules' forward passes and against the JAX executor
on the same bytes (``tests/test_torch_onnx.py``), including a
Silero-v5-shaped conv + LSTM + sigmoid network.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

# ---------------------------------------------------------------------------
# Protobuf wire-format reader
# ---------------------------------------------------------------------------


def _read_varint(buf: bytes, pos: int) -> Tuple[int, int]:
    result = 0
    shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _parse_fields(buf: bytes) -> Dict[int, List[Tuple[int, Any]]]:
    """Decode one message into {field_no: [(wire_type, raw_value), ...]}."""
    fields: Dict[int, List[Tuple[int, Any]]] = {}
    pos = 0
    end = len(buf)
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field_no, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val = buf[pos:pos + 8]
            pos += 8
        elif wire == 2:
            length, pos = _read_varint(buf, pos)
            val = buf[pos:pos + length]
            pos += length
        elif wire == 5:
            val = buf[pos:pos + 4]
            pos += 4
        else:  # pragma: no cover - groups are not used by ONNX
            raise ValueError(f"unsupported wire type {wire}")
        fields.setdefault(field_no, []).append((wire, val))
    return fields


def _get_bytes(fields, no, default=b"") -> bytes:
    vals = fields.get(no)
    return vals[-1][1] if vals else default


def _get_str(fields, no, default="") -> str:
    return _get_bytes(fields, no, default.encode()).decode("utf-8", "replace")


def _get_int(fields, no, default=0) -> int:
    vals = fields.get(no)
    return vals[-1][1] if vals else default


def _signed(v: int) -> int:
    """Protobuf int64 varints are two's-complement over 64 bits."""
    return v - (1 << 64) if v >= (1 << 63) else v


def _packed_ints(fields, no) -> List[int]:
    out: List[int] = []
    for wire, val in fields.get(no, []):
        if wire == 0:
            out.append(_signed(val))
        else:  # packed
            pos = 0
            while pos < len(val):
                v, pos = _read_varint(val, pos)
                out.append(_signed(v))
    return out


def _packed_floats(fields, no) -> List[float]:
    out: List[float] = []
    for wire, val in fields.get(no, []):
        if wire == 5:
            out.append(struct.unpack("<f", val)[0])
        else:
            out.extend(np.frombuffer(val, "<f4").tolist())
    return out


# ONNX TensorProto.DataType -> numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}


def _parse_tensor(buf: bytes) -> Tuple[str, np.ndarray]:
    f = _parse_fields(buf)
    dims = _packed_ints(f, 1)
    dtype = _DTYPES.get(_get_int(f, 2, 1), np.float32)
    name = _get_str(f, 8)
    raw = _get_bytes(f, 9)
    if raw:
        arr = np.frombuffer(raw, dtype=dtype)
    elif 4 in f:
        arr = np.asarray(_packed_floats(f, 4), np.float32)
    elif 7 in f:
        arr = np.asarray(_packed_ints(f, 7), np.int64)
    elif 5 in f:
        arr = np.asarray(_packed_ints(f, 5), np.int32).astype(dtype)
    else:
        arr = np.zeros(0, dtype)
    return name, arr.reshape(dims) if dims else arr.reshape(())


@dataclass
class OnnxAttr:
    name: str
    value: Any


def _parse_attribute(buf: bytes) -> OnnxAttr:
    f = _parse_fields(buf)
    name = _get_str(f, 1)
    atype = _get_int(f, 20, 0)
    if atype == 1:    # FLOAT
        return OnnxAttr(name, struct.unpack("<f", _get_bytes(f, 2))[0])
    if atype == 2:    # INT
        return OnnxAttr(name, _signed(_get_int(f, 3)))
    if atype == 3:    # STRING
        return OnnxAttr(name, _get_bytes(f, 4).decode("utf-8", "replace"))
    if atype == 4:    # TENSOR
        return OnnxAttr(name, _parse_tensor(_get_bytes(f, 5))[1])
    if atype == 5:    # GRAPH
        return OnnxAttr(name, _parse_graph(_get_bytes(f, 6)))
    if atype == 6:    # FLOATS
        return OnnxAttr(name, _packed_floats(f, 7))
    if atype == 7:    # INTS
        return OnnxAttr(name, _packed_ints(f, 8))
    if atype == 8:    # STRINGS
        return OnnxAttr(name, [v.decode() for _, v in f.get(9, [])])
    return OnnxAttr(name, None)


@dataclass
class OnnxNode:
    op_type: str
    inputs: List[str]
    outputs: List[str]
    attrs: Dict[str, Any]
    name: str = ""


@dataclass
class OnnxGraph:
    nodes: List[OnnxNode]
    initializers: Dict[str, np.ndarray]
    inputs: List[str]               # non-initializer graph inputs, in order
    outputs: List[str]
    input_shapes: Dict[str, List[Optional[int]]] = field(default_factory=dict)


def _parse_value_info(buf: bytes) -> Tuple[str, List[Optional[int]]]:
    f = _parse_fields(buf)
    name = _get_str(f, 1)
    shape: List[Optional[int]] = []
    type_buf = _get_bytes(f, 2)
    if type_buf:
        tf = _parse_fields(type_buf)
        tensor_buf = _get_bytes(tf, 1)
        if tensor_buf:
            ttf = _parse_fields(tensor_buf)
            shape_buf = _get_bytes(ttf, 2)
            if shape_buf:
                sf = _parse_fields(shape_buf)
                for _, dim_buf in sf.get(1, []):
                    df = _parse_fields(dim_buf)
                    if 1 in df:
                        shape.append(_get_int(df, 1))
                    else:
                        shape.append(None)  # symbolic dim
    return name, shape


def _parse_graph(buf: bytes) -> OnnxGraph:
    f = _parse_fields(buf)
    nodes = []
    for _, node_buf in f.get(1, []):
        nf = _parse_fields(node_buf)
        nodes.append(OnnxNode(
            op_type=_get_str(nf, 4),
            inputs=[v.decode() for _, v in nf.get(1, [])],
            outputs=[v.decode() for _, v in nf.get(2, [])],
            attrs={
                a.name: a.value
                for a in (_parse_attribute(v) for _, v in nf.get(5, []))
            },
            name=_get_str(nf, 3),
        ))
    initializers = dict(
        _parse_tensor(v) for _, v in f.get(5, [])
    )
    inputs = []
    input_shapes: Dict[str, List[Optional[int]]] = {}
    for _, vi_buf in f.get(11, []):
        name, shape = _parse_value_info(vi_buf)
        if name not in initializers:
            inputs.append(name)
            input_shapes[name] = shape
    outputs = [_parse_value_info(v)[0] for _, v in f.get(12, [])]
    return OnnxGraph(nodes, initializers, inputs, outputs, input_shapes)


def load_onnx_graph(path: str) -> OnnxGraph:
    """Parse a .onnx file's graph (ModelProto.graph is field 7)."""
    with open(path, "rb") as fh:
        model = _parse_fields(fh.read())
    return _parse_graph(_get_bytes(model, 7))


# ---------------------------------------------------------------------------
# Graph interpreter (torch; numpy constants fold on the host)
# ---------------------------------------------------------------------------

_TORCH_DTYPES = {
    np.dtype(np.float32): torch.float32, np.dtype(np.float64): torch.float64,
    np.dtype(np.float16): torch.float16, np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32, np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8, np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def _is_np(*vals) -> bool:
    return all(isinstance(v, (np.ndarray, np.generic, int, float)) for v in vals)


def _persistent(graph: OnnxGraph, out: Dict[int, np.ndarray]) -> Dict[int, np.ndarray]:
    """The arrays that live as long as the graph (initializers and
    ``Constant`` values, subgraphs included), by id."""
    for arr in graph.initializers.values():
        out[id(arr)] = arr
    for node in graph.nodes:
        for value in node.attrs.values():
            if isinstance(value, np.ndarray):
                out[id(value)] = value
            elif isinstance(value, OnnxGraph):
                _persistent(value, out)
    return out


class _Ctx:
    """One run's device and the graph's per-device copies of its
    persistent arrays."""

    def __init__(self, graph: OnnxGraph, device: torch.device) -> None:
        self.device = device
        cache = graph.__dict__.setdefault("_torch_consts", {})
        if "_persistent" not in cache:
            cache["_persistent"] = _persistent(graph, {})
        self.persistent = cache["_persistent"]
        self.cache = cache.setdefault(str(device), {})

    def t(self, x, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """``x`` as a tensor on the run's device (numpy copied; a
        persistent array once per device)."""
        if torch.is_tensor(x):
            return x if dtype is None else x.to(dtype)
        key = id(x)
        if key in self.persistent and self.persistent[key] is x:
            found = self.cache.get(key)
            if found is None:
                found = self.cache[key] = self._upload(x)
            return found if dtype is None else found.to(dtype)
        out = self._upload(x)
        return out if dtype is None else out.to(dtype)

    def _upload(self, x) -> torch.Tensor:
        arr = np.asarray(x)
        if not (arr.flags.writeable and arr.flags.c_contiguous):
            # initializers are read straight from the file's bytes; a copy
            # keeps a 0-d array 0-d (np.ascontiguousarray would not)
            arr = arr.copy()
        return torch.from_numpy(arr).to(self.device)


def _conv(ctx: _Ctx, x, w, b, attrs):
    x, w = ctx.t(x, torch.float32), ctx.t(w, torch.float32)
    n_spatial = x.dim() - 2
    if n_spatial not in (1, 2, 3):  # pragma: no cover
        raise ValueError("conv with >3 spatial dims")
    strides = [int(s) for s in (attrs.get("strides") or [1] * n_spatial)]
    dil = [int(d) for d in (attrs.get("dilations") or [1] * n_spatial)]
    groups = int(attrs.get("group", 1) or 1)
    pads = attrs.get("pads")
    if pads:
        # ONNX: all begins then all ends; F.pad: last dim first
        pairs = []
        for i in reversed(range(n_spatial)):
            pairs += [int(pads[i]), int(pads[i + n_spatial])]
        x = F.pad(x, pairs)
    conv = (F.conv1d, F.conv2d, F.conv3d)[n_spatial - 1]
    return conv(x, w, None if b is None else ctx.t(b, torch.float32), stride=strides,
                dilation=dil, groups=groups)


def _lstm(ctx: _Ctx, env, node) -> None:
    """ONNX LSTM (single layer, forward): gate order i, o, f, c."""
    ins = node.inputs
    x = ctx.t(env[ins[0]], torch.float32)            # (T, B, I)
    w = ctx.t(env[ins[1]], torch.float32)[0]         # (4H, I)
    r = ctx.t(env[ins[2]], torch.float32)[0]         # (4H, H)
    hidden = r.shape[1]
    b_name = ins[3] if len(ins) > 3 and ins[3] else None
    if b_name:
        bb = ctx.t(env[b_name], torch.float32)[0]    # (8H,)
        bias = bb[:4 * hidden] + bb[4 * hidden:]
    else:
        bias = torch.zeros(4 * hidden, device=ctx.device)
    batch = x.shape[1]
    h0_name = ins[5] if len(ins) > 5 and ins[5] else None
    c0_name = ins[6] if len(ins) > 6 and ins[6] else None
    h = (ctx.t(env[h0_name], torch.float32)[0] if h0_name
         else torch.zeros(batch, hidden, device=ctx.device))
    c = (ctx.t(env[c0_name], torch.float32)[0] if c0_name
         else torch.zeros(batch, hidden, device=ctx.device))
    ys = []
    for t in range(x.shape[0]):
        gates = x[t] @ w.T + h @ r.T + bias
        i_g, o_g, f_g, c_g = torch.chunk(gates, 4, dim=-1)
        i_g = 1.0 / (1.0 + torch.exp(-i_g))
        o_g = 1.0 / (1.0 + torch.exp(-o_g))
        f_g = 1.0 / (1.0 + torch.exp(-f_g))
        c = f_g * c + i_g * torch.tanh(c_g)
        h = o_g * torch.tanh(c)
        ys.append(h)
    outs = node.outputs
    if outs and outs[0]:
        env[outs[0]] = torch.stack(ys)[:, None, :, :]   # (T, 1, B, H)
    if len(outs) > 1 and outs[1]:
        env[outs[1]] = h[None]                          # (1, B, H)
    if len(outs) > 2 and outs[2]:
        env[outs[2]] = c[None]


def _pad(ctx: _Ctx, x, pads, mode, value):
    n = x.ndim
    pairs = [(int(pads[i]), int(pads[i + n])) for i in range(n)]
    if _is_np(x):
        if mode in ("reflect", "edge"):
            return np.pad(x, pairs, mode=mode)
        return np.pad(x, pairs, mode="constant", constant_values=value)
    flat = []
    for lo, hi in reversed(pairs):
        flat += [lo, hi]
    while len(flat) > 2 and flat[-2:] == [0, 0]:
        flat = flat[:-2]
    x = ctx.t(x)
    if mode in ("reflect", "edge"):
        return F.pad(x, flat, mode="reflect" if mode == "reflect" else "replicate")
    return F.pad(x, flat, mode="constant", value=value)


def _slice_op(ctx: _Ctx, env, node):
    x = env[node.inputs[0]]
    if len(node.inputs) > 1:  # opset >= 10: runtime inputs
        starts = np.asarray(env[node.inputs[1]]).tolist()
        ends = np.asarray(env[node.inputs[2]]).tolist()
        axes = (np.asarray(env[node.inputs[3]]).tolist()
                if len(node.inputs) > 3 and node.inputs[3] else list(range(len(starts))))
        steps = (np.asarray(env[node.inputs[4]]).tolist()
                 if len(node.inputs) > 4 and node.inputs[4] else [1] * len(starts))
    else:  # opset 1: attributes
        starts = node.attrs["starts"]
        ends = node.attrs["ends"]
        axes = node.attrs.get("axes") or list(range(len(starts)))
        steps = [1] * len(starts)
    big = int(np.iinfo(np.int64).max)
    out = x
    for st, en, ax, sp in zip(starts, ends, axes, steps):
        ax = int(ax) % x.ndim
        st, en, sp = int(st), int(en), int(sp)
        en = None if en >= big else en
        sl = slice(st, en, sp)
        if _is_np(out) or sp > 0:
            index = [slice(None)] * x.ndim
            index[ax] = sl
            out = out[tuple(index)]
        else:  # torch has no negative-step slices
            idx = range(*sl.indices(out.shape[ax]))
            out = out.index_select(ax, torch.tensor(list(idx), device=out.device,
                                                    dtype=torch.long))
    return out


def _axes_arg(env, node, attr="axes", input_idx=1):
    if attr in node.attrs and node.attrs[attr] is not None:
        return [int(a) for a in node.attrs[attr]]
    if len(node.inputs) > input_idx and node.inputs[input_idx]:
        return [int(a) for a in np.asarray(env[node.inputs[input_idx]])]
    return None


_BINARY = {
    "Add": (np.add, torch.add), "Sub": (np.subtract, torch.sub),
    "Mul": (np.multiply, torch.mul), "Div": (np.divide, torch.div),
    "Pow": (np.power, torch.pow), "Equal": (np.equal, torch.eq),
    "Greater": (np.greater, torch.gt), "Less": (np.less, torch.lt),
}
_UNARY = {
    "Sqrt": (np.sqrt, torch.sqrt), "Exp": (np.exp, torch.exp), "Log": (np.log, torch.log),
    "Abs": (np.abs, torch.abs), "Tanh": (np.tanh, torch.tanh),
    "Not": (np.logical_not, torch.logical_not),
}
_REDUCE = {
    "ReduceMean": (np.mean, torch.mean), "ReduceSum": (np.sum, torch.sum),
    "ReduceMax": (np.max, torch.amax), "ReduceMin": (np.min, torch.amin),
}


def _reduce(x, np_fn, torch_fn, axes, keep):
    if _is_np(x):
        return np_fn(x, axis=tuple(axes) if axes else None, keepdims=keep)
    dims = tuple(axes) if axes else tuple(range(x.dim()))
    return torch_fn(x, dim=dims, keepdim=keep)


def run_graph(graph: OnnxGraph, env: Dict[str, Any],
              device: Optional[torch.device] = None) -> List[Any]:
    """Execute nodes in graph order; ``env`` maps input names to tensors
    (on the run's device) or numpy arrays (constants, which fold on the
    host). ``device`` defaults to the first tensor input's, else the CPU.
    Returns the outputs: tensors, or numpy where the output folded."""
    if device is None:
        device = next((v.device for v in env.values() if torch.is_tensor(v)),
                      torch.device("cpu"))
    ctx = _Ctx(graph, torch.device(device))
    return _run(ctx, graph, env)


def _run(ctx: _Ctx, graph: OnnxGraph, env: Dict[str, Any]) -> List[Any]:
    env = dict(env)
    for name, arr in graph.initializers.items():
        env.setdefault(name, arr)
    env[""] = None
    t = ctx.t

    for node in graph.nodes:
        op = node.op_type
        ins = [env[n] if n else None for n in node.inputs]
        a = node.attrs
        if op == "Constant":
            out = a.get("value")
            if out is None and "value_float" in a:
                out = np.float32(a["value_float"])
            if out is None and "value_int" in a:
                out = np.int64(a["value_int"])
        elif op == "Conv":
            out = _conv(ctx, ins[0], ins[1], ins[2] if len(ins) > 2 else None, a)
        elif op == "LSTM":
            _lstm(ctx, env, node)
            continue
        elif op == "Gemm":
            x, w = ins[0], ins[1]
            if not _is_np(x, w):
                x, w = t(x), t(w)
            if int(a.get("transA", 0)):
                x = x.T
            if int(a.get("transB", 0)):
                w = w.T
            out = float(a.get("alpha", 1.0)) * (x @ w)
            if len(ins) > 2 and ins[2] is not None:
                c = ins[2] if _is_np(out, ins[2]) else t(ins[2])
                out = out + float(a.get("beta", 1.0)) * c
        elif op == "MatMul":
            out = ins[0] @ ins[1] if _is_np(*ins) else t(ins[0]) @ t(ins[1])
        elif op in _BINARY:
            np_fn, torch_fn = _BINARY[op]
            out = np_fn(ins[0], ins[1]) if _is_np(*ins) else torch_fn(t(ins[0]), t(ins[1]))
        elif op in _UNARY:
            np_fn, torch_fn = _UNARY[op]
            out = np_fn(ins[0]) if _is_np(ins[0]) else torch_fn(ins[0])
        elif op == "Neg":
            out = -ins[0]
        elif op == "Relu":
            out = np.maximum(ins[0], 0) if _is_np(ins[0]) else torch.relu(ins[0])
        elif op == "Sigmoid":
            exp = np.exp if _is_np(ins[0]) else torch.exp
            out = 1.0 / (1.0 + exp(-ins[0]))
        elif op == "Softmax":
            out = torch.softmax(t(ins[0]), dim=int(a.get("axis", -1)))
        elif op == "Concat":
            parts = [i for i in ins if i is not None]
            axis = int(a.get("axis", 0))
            out = (np.concatenate(parts, axis=axis) if _is_np(*parts)
                   else torch.cat([t(p) for p in parts], dim=axis))
        elif op == "Slice":
            out = _slice_op(ctx, env, node)
        elif op == "Squeeze":
            axes = _axes_arg(env, node)
            x = ins[0]
            if _is_np(x):
                out = np.squeeze(x, axis=tuple(axes)) if axes else np.squeeze(x)
            else:
                out = x.squeeze(tuple(ax % x.dim() for ax in axes)) if axes else x.squeeze()
        elif op == "Unsqueeze":
            axes = _axes_arg(env, node) or [0]
            out = ins[0]
            for ax in sorted(int(x) for x in axes):
                out = np.expand_dims(out, axis=ax) if _is_np(out) else out.unsqueeze(ax)
        elif op == "Reshape":
            shape = [int(s) for s in np.asarray(env[node.inputs[1]])]
            if not int(a.get("allowzero", 0)):
                shape = [ins[0].shape[i] if s == 0 else s for i, s in enumerate(shape)]
            out = ins[0].reshape(shape)
        elif op == "Transpose":
            perm = a.get("perm")
            if _is_np(ins[0]):
                out = ins[0].transpose(perm) if perm is not None else ins[0].T
            else:
                out = ins[0].permute(*perm) if perm is not None else ins[0].permute(
                    *reversed(range(ins[0].dim())))
        elif op == "Flatten":
            ax = int(a.get("axis", 1))
            lead = int(np.prod(ins[0].shape[:ax])) if ax else 1
            out = ins[0].reshape(lead, -1)
        elif op == "Pad":
            if len(node.inputs) > 1 and node.inputs[1]:
                pads = [int(p) for p in np.asarray(env[node.inputs[1]])]
                value = (float(np.asarray(env[node.inputs[2]]))
                         if len(node.inputs) > 2 and node.inputs[2] else 0.0)
            else:
                pads = [int(p) for p in a.get("pads", [])]
                value = float(a.get("value", 0.0))
            mode = a.get("mode", "constant")
            if isinstance(mode, bytes):
                mode = mode.decode()
            out = _pad(ctx, ins[0], pads, mode, value)
        elif op in _REDUCE:
            np_fn, torch_fn = _REDUCE[op]
            out = _reduce(ins[0], np_fn, torch_fn, _axes_arg(env, node),
                          bool(int(a.get("keepdims", 1))))
        elif op == "Cast":
            to = _DTYPES.get(int(a.get("to", 1)), np.float32)
            out = (np.asarray(ins[0]).astype(to) if _is_np(ins[0])
                   else ins[0].to(_TORCH_DTYPES[np.dtype(to)]))
        elif op == "Shape":
            out = np.asarray(ins[0].shape, np.int64)
        elif op == "Gather":
            ax = int(a.get("axis", 0))
            if _is_np(*ins):
                out = np.take(ins[0], np.asarray(ins[1], np.int64), axis=ax)
            else:
                x = t(ins[0])
                ax = ax % x.dim()
                idx = t(ins[1], torch.long)
                flat = torch.remainder(idx.reshape(-1), x.shape[ax])
                out = x.index_select(ax, flat).reshape(
                    *x.shape[:ax], *idx.shape, *x.shape[ax + 1:])
        elif op == "ConstantOfShape":
            shape = [int(s) for s in np.asarray(ins[0])]
            value = a.get("value")
            fill = value.reshape(-1)[0] if value is not None else np.float32(0)
            out = np.full(shape, fill)
        elif op == "Expand":
            shape = [int(s) for s in np.asarray(env[node.inputs[1]])]
            target = tuple(max(s, d) for s, d in zip(
                shape, [1] * (len(shape) - ins[0].ndim) + list(ins[0].shape)))
            out = (np.broadcast_to(ins[0], target) if _is_np(ins[0])
                   else ins[0].broadcast_to(target))
        elif op == "Where":
            out = (np.where(ins[0], ins[1], ins[2]) if _is_np(*ins)
                   else torch.where(t(ins[0], torch.bool), t(ins[1]), t(ins[2])))
        elif op == "If":
            # constant-folded on the host (e.g. sr); a tensor condition is
            # read from the device
            cond = bool(np.asarray(ins[0])) if _is_np(ins[0]) else bool(ins[0])
            branch = a["then_branch"] if cond else a["else_branch"]
            sub_out = _run(ctx, branch, env)
            for name, val in zip(node.outputs, sub_out):
                env[name] = val
            continue
        elif op in ("Identity", "Dropout"):
            out = ins[0]
        elif op == "Clip":
            lo = ins[1] if len(ins) > 1 and ins[1] is not None else a.get("min")
            hi = ins[2] if len(ins) > 2 and ins[2] is not None else a.get("max")
            if _is_np(ins[0]):
                out = np.clip(ins[0], lo, hi)
            else:
                out = torch.clamp(ins[0], None if lo is None else float(np.asarray(lo)),
                                  None if hi is None else float(np.asarray(hi)))
        elif op == "LeakyRelu":
            alpha = float(a.get("alpha", 0.01))
            x = ins[0]
            out = (np.where(x >= 0, x, alpha * x) if _is_np(x)
                   else torch.where(x >= 0, x, alpha * x))
        elif op == "ReduceL2":
            axes = _axes_arg(env, node)
            keep = bool(int(a.get("keepdims", 1)))
            x = ins[0]
            if _is_np(x):
                out = np.sqrt(np.sum(np.square(x), axis=tuple(axes) if axes else None,
                                     keepdims=keep))
            else:
                dims = tuple(axes) if axes else tuple(range(x.dim()))
                out = torch.sqrt(torch.sum(x * x, dim=dims, keepdim=keep))
        else:
            raise NotImplementedError(f"ONNX op not supported: {op}")
        env[node.outputs[0]] = out

    return [env[name] for name in graph.outputs]


__all__ = ["OnnxGraph", "OnnxNode", "load_onnx_graph", "run_graph"]

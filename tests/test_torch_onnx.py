"""The port's ONNX executor and Silero wrapper against torch and the JAX executor.

Counterparts of ``tests/test_onnx_jax.py``: every graph is hand-encoded with
that module's protobuf writer, its weights copied from torch modules, and
run three ways on the same bytes: the torch modules' forward pass, the JAX
package's executor (``stt_tpu/ops/onnx_jax.py``) and the port's
(``stt_tpu_torch/ops/onnx_torch.py``) on the CPU; outputs within 1e-5 (the
Silero stream's probabilities within 1e-4 of torch, as the JAX tests hold
theirs, and within 1e-5 of the JAX executor). Constant subexpressions stay
numpy on the host (an ``If`` on the sample rate takes its branch there).
A Silero-v5-shaped graph (input [B, 576], one state [2, B, 128], an ``sr``
input switching between two branches) runs through
:class:`~stt_tpu_torch.ops.silero.SileroVad` over a stream. No Silero ONNX
file is in the repository, so the real export is not scored here.
"""

import numpy as np
import pytest
import torch

from stt_tpu.ops import onnx_jax as J
from stt_tpu_torch.ops import onnx_torch as T
from tests.test_onnx_jax import (  # noqa: F401 (tiny_silero is a fixture)
    _lstm_onnx_weights,
    _np,
    _pb_tensor,
    attr_graph,
    attr_int,
    attr_ints,
    attr_string,
    graph,
    node,
    tiny_silero,
    write_model,
)
from tests.test_torch_whisper import one_torch_thread  # noqa: F401 (autouse)

ATOL = 1e-5


def _both(path, env):
    """(port outputs as numpy, JAX outputs as numpy) of one file."""
    t_out = T.run_graph(T.load_onnx_graph(path), {
        k: torch.from_numpy(v) if isinstance(v, np.ndarray) and v.dtype == np.float32 else v
        for k, v in env.items()})
    j_out = J.run_graph(J.load_onnx_graph(path), env)
    as_np = [o.numpy() if torch.is_tensor(o) else np.asarray(o) for o in t_out]
    return as_np, [np.asarray(o) for o in j_out]


def test_parser_reads_the_jax_parsers_graph(tiny_silero):
    _, path = tiny_silero
    t, j = T.load_onnx_graph(path), J.load_onnx_graph(path)
    assert [n.op_type for n in t.nodes] == [n.op_type for n in j.nodes]
    assert t.inputs == j.inputs and t.outputs == j.outputs
    assert t.input_shapes == j.input_shapes
    assert set(t.initializers) == set(j.initializers)
    for name, arr in t.initializers.items():
        np.testing.assert_array_equal(arr, j.initializers[name])


def test_mlp_matches_torch_and_jax(tmp_path):
    torch.manual_seed(0)
    l1, l2 = torch.nn.Linear(8, 16), torch.nn.Linear(16, 4)
    x = torch.randn(3, 8)
    expected = torch.sigmoid(l2(torch.relu(l1(x)))).detach().numpy()
    g = graph(
        nodes=[
            node("Gemm", ["input", "w1", "b1"], ["h1"], attr_int("transB", 1)),
            node("Relu", ["h1"], ["h2"]),
            node("Gemm", ["h2", "w2", "b2"], ["h3"], attr_int("transB", 1)),
            node("Sigmoid", ["h3"], ["output"]),
        ],
        initializers=[_pb_tensor("w1", _np(l1.weight)), _pb_tensor("b1", _np(l1.bias)),
                      _pb_tensor("w2", _np(l2.weight)), _pb_tensor("b2", _np(l2.bias))],
        inputs=[("input", (3, 8))], outputs=["output"],
    )
    (got,), (ref,) = _both(write_model(tmp_path / "mlp.onnx", g), {"input": x.numpy()})
    np.testing.assert_allclose(got, expected, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_conv1d_stack_matches_torch_and_jax(tmp_path):
    torch.manual_seed(1)
    c1 = torch.nn.Conv1d(1, 8, 5, stride=2, padding=2)
    c2 = torch.nn.Conv1d(8, 4, 3, stride=1, padding=1)
    x = torch.randn(2, 1, 64)
    expected = torch.relu(c2(torch.relu(c1(x)))).mean(-1).detach().numpy()
    g = graph(
        nodes=[
            node("Conv", ["input", "w1", "b1"], ["h1"],
                 attr_ints("strides", [2]) + attr_ints("pads", [2, 2])
                 + attr_ints("kernel_shape", [5])),
            node("Relu", ["h1"], ["h2"]),
            node("Conv", ["h2", "w2", "b2"], ["h3"],
                 attr_ints("strides", [1]) + attr_ints("pads", [1, 1])
                 + attr_ints("kernel_shape", [3])),
            node("Relu", ["h3"], ["h4"]),
            node("ReduceMean", ["h4"], ["output"],
                 attr_ints("axes", [-1]) + attr_int("keepdims", 0)),
        ],
        initializers=[_pb_tensor("w1", _np(c1.weight)), _pb_tensor("b1", _np(c1.bias)),
                      _pb_tensor("w2", _np(c2.weight)), _pb_tensor("b2", _np(c2.bias))],
        inputs=[("input", (2, 1, 64))], outputs=["output"],
    )
    (got,), (ref,) = _both(write_model(tmp_path / "conv.onnx", g), {"input": x.numpy()})
    np.testing.assert_allclose(got, expected, atol=ATOL)
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_asymmetric_conv_padding_matches_jax(tmp_path):
    torch.manual_seed(4)
    w = torch.randn(3, 2, 4)
    x = np.random.default_rng(4).normal(0, 1, (1, 2, 20)).astype(np.float32)
    g = graph(
        nodes=[node("Conv", ["input", "w"], ["output"],
                    attr_ints("strides", [3]) + attr_ints("pads", [1, 2])
                    + attr_ints("dilations", [2]))],
        initializers=[_pb_tensor("w", _np(w))],
        inputs=[("input", (1, 2, 20))], outputs=["output"],
    )
    (got,), (ref,) = _both(write_model(tmp_path / "apad.onnx", g), {"input": x})
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, atol=ATOL)


def test_lstm_with_state_matches_torch_and_jax(tmp_path):
    torch.manual_seed(2)
    lstm = torch.nn.LSTM(6, 10)
    x, h, c = torch.randn(4, 2, 6), torch.randn(1, 2, 10), torch.randn(1, 2, 10)
    ty, (thn, tcn) = lstm(x, (h, c))
    w, r, b = _lstm_onnx_weights(lstm)
    g = graph(
        nodes=[node("LSTM", ["x", "W", "R", "B", "", "h0", "c0"], ["y", "hn", "cn"],
                    attr_int("hidden_size", 10))],
        initializers=[_pb_tensor("W", w), _pb_tensor("R", r), _pb_tensor("B", b)],
        inputs=[("x", (4, 2, 6)), ("h0", (1, 2, 10)), ("c0", (1, 2, 10))],
        outputs=["y", "hn", "cn"],
    )
    got, ref = _both(write_model(tmp_path / "lstm.onnx", g),
                     {"x": x.numpy(), "h0": h.numpy(), "c0": c.numpy()})
    np.testing.assert_allclose(got[0].reshape(ty.shape), ty.detach().numpy(), atol=ATOL)
    np.testing.assert_allclose(got[1], thn.detach().numpy(), atol=ATOL)
    np.testing.assert_allclose(got[2], tcn.detach().numpy(), atol=ATOL)
    for a, bb in zip(got, ref):
        np.testing.assert_allclose(a, bb, atol=ATOL)


def _if_graph(tmp_path, sr_value):
    def branch(op, const_name, const_val):
        const = _pb_tensor(const_name, np.asarray(const_val, np.float32))
        return graph([node(op, ["x", const_name], ["y"])], [const], [], ["y"])

    if_attrs = attr_graph("then_branch", branch("Mul", "two", 2.0))
    if_attrs += attr_graph("else_branch", branch("Add", "one", 1.0))
    g = graph(
        nodes=[node("Equal", ["sr", "sr16"], ["cond"]), node("If", ["cond"], ["y"], if_attrs)],
        initializers=[_pb_tensor("sr", np.asarray(sr_value, np.int64)),
                      _pb_tensor("sr16", np.asarray(16000, np.int64))],
        inputs=[("x", (2,))], outputs=["y"],
    )
    return write_model(tmp_path / f"if{sr_value}.onnx", g)


@pytest.mark.parametrize("sr,expect", [(16000, lambda x: x * 2.0), (8000, lambda x: x + 1.0)])
def test_if_node_constant_folds_on_the_host(tmp_path, sr, expect):
    """An If whose condition comes from initializers takes its branch on
    the host: the graph runs on the meta device, where a tensor can never
    be read, and gives the branch's shape."""
    x = np.asarray([3.0, 4.0], np.float32)
    path = _if_graph(tmp_path, sr)
    (got,), (ref,) = _both(path, {"x": x})
    np.testing.assert_allclose(got, expect(x))
    np.testing.assert_allclose(got, ref)
    (meta,) = T.run_graph(T.load_onnx_graph(path), {"x": torch.from_numpy(x).to("meta")})
    assert meta.device.type == "meta" and meta.shape == (2,)


def test_shape_ops_match_numpy_and_jax(tmp_path):
    """Slice (input-style), Unsqueeze, Squeeze, Concat, Transpose, Pad
    (reflection): the glue ops of real Silero exports."""
    x = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    g = graph(
        nodes=[
            node("Slice", ["input", "starts", "ends", "axes"], ["s"]),
            node("Unsqueeze", ["s", "uaxes"], ["u"]),
            node("Squeeze", ["u", "uaxes"], ["q"]),
            node("Transpose", ["q"], ["t"], attr_ints("perm", [1, 0, 2])),
            node("Concat", ["t", "t"], ["cat"], attr_int("axis", 0)),
            node("Pad", ["cat", "pads"], ["output"], attr_string("mode", "reflect")),
        ],
        initializers=[
            _pb_tensor("starts", np.asarray([1], np.int64)),
            _pb_tensor("ends", np.asarray([3], np.int64)),
            _pb_tensor("axes", np.asarray([2], np.int64)),
            _pb_tensor("uaxes", np.asarray([0], np.int64)),
            _pb_tensor("pads", np.asarray([0, 0, 1, 0, 0, 1], np.int64)),
        ],
        inputs=[("input", (2, 3, 4))], outputs=["output"],
    )
    (got,), (ref,) = _both(write_model(tmp_path / "shape.onnx", g), {"input": x})
    want = x[:, :, 1:3].transpose(1, 0, 2)
    want = np.pad(np.concatenate([want, want], axis=0), ((0, 0), (0, 0), (1, 1)),
                  mode="reflect")
    np.testing.assert_allclose(got, want)
    np.testing.assert_allclose(got, ref)


def test_more_ops_match_jax(tmp_path):
    """Gather, Reshape, Flatten, Softmax, Clip, Where, LeakyRelu, Cast,
    ReduceSum/Max/L2, Exp/Log/Sqrt/Abs/Neg/Tanh/Sub/Div/Pow, Expand,
    Shape-driven reshapes and constant-pad: each against the JAX executor."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (2, 3, 4)).astype(np.float32)
    g = graph(
        nodes=[
            node("Abs", ["input"], ["a"]),
            node("Add", ["a", "one"], ["a1"]),
            node("Log", ["a1"], ["l"]),
            node("Sqrt", ["a1"], ["sq"]),
            node("Exp", ["l"], ["e"]),
            node("Sub", ["e", "sq"], ["d"]),
            node("Div", ["d", "a1"], ["dv"]),
            node("Pow", ["dv", "two"], ["p"]),
            node("Neg", ["p"], ["n"]),
            node("Tanh", ["n"], ["th"]),
            node("LeakyRelu", ["input"], ["lr"]),
            node("Softmax", ["lr"], ["sm"], attr_int("axis", -1)),
            node("Clip", ["sm", "lo", "hi"], ["cl"]),
            node("Greater", ["input", "zero"], ["gt"]),
            node("Where", ["gt", "cl", "th"], ["w"]),
            node("Gather", ["w", "idx"], ["ga"], attr_int("axis", 2)),
            node("Shape", ["ga"], ["shp"]),
            node("Reshape", ["ga", "newshape"], ["rs"]),
            node("Flatten", ["rs"], ["fl"], attr_int("axis", 1)),
            node("ReduceSum", ["fl"], ["rsum"], attr_ints("axes", [1]) + attr_int("keepdims", 1)),
            node("ReduceMax", ["fl"], ["rmax"], attr_ints("axes", [1]) + attr_int("keepdims", 1)),
            node("ReduceL2", ["fl"], ["rl2"], attr_ints("axes", [1]) + attr_int("keepdims", 1)),
            node("Concat", ["rsum", "rmax", "rl2"], ["stats"], attr_int("axis", 1)),
            node("Expand", ["stats", "eshape"], ["ex"]),
            node("Cast", ["ex"], ["c64"], attr_int("to", 11)),
            node("Cast", ["c64"], ["c32"], attr_int("to", 1)),
            node("Pad", ["c32", "cpads", "cval"], ["output"]),
        ],
        initializers=[
            _pb_tensor("one", np.asarray(1.0, np.float32)),
            _pb_tensor("two", np.asarray(2.0, np.float32)),
            _pb_tensor("zero", np.asarray(0.0, np.float32)),
            _pb_tensor("lo", np.asarray(0.1, np.float32)),
            _pb_tensor("hi", np.asarray(0.6, np.float32)),
            _pb_tensor("idx", np.asarray([3, 0, -1], np.int64)),
            _pb_tensor("newshape", np.asarray([2, -1], np.int64)),
            _pb_tensor("eshape", np.asarray([2, 2, 3], np.int64)),
            _pb_tensor("cpads", np.asarray([0, 1, 0, 0, 2, 0], np.int64)),
            _pb_tensor("cval", np.asarray(0.5, np.float32)),
        ],
        inputs=[("input", (2, 3, 4))], outputs=["output", "shp"],
    )
    got, ref = _both(write_model(tmp_path / "more.onnx", g), {"input": x})
    assert got[0].shape == ref[0].shape == (2, 5, 3)
    np.testing.assert_allclose(got[0], ref[0], atol=ATOL)
    np.testing.assert_array_equal(got[1], ref[1])


def test_negative_step_slice_matches_numpy(tmp_path):
    x = np.arange(10, dtype=np.float32).reshape(2, 5)
    g = graph(
        nodes=[node("Slice", ["input", "st", "en", "ax", "sp"], ["output"])],
        initializers=[_pb_tensor("st", np.asarray([-1], np.int64)),
                      _pb_tensor("en", np.asarray([-6], np.int64)),
                      _pb_tensor("ax", np.asarray([1], np.int64)),
                      _pb_tensor("sp", np.asarray([-2], np.int64))],
        inputs=[("input", (2, 5))], outputs=["output"],
    )
    path = write_model(tmp_path / "neg.onnx", g)
    (got,) = T.run_graph(T.load_onnx_graph(path), {"input": torch.from_numpy(x)})
    np.testing.assert_array_equal(got.numpy(), x[:, -1:-6:-2])


def test_initializers_are_copied_to_the_device_once(tiny_silero):
    _, path = tiny_silero
    g = T.load_onnx_graph(path)
    window = torch.zeros(1, 576)
    h = torch.zeros(1, 1, 24)
    T.run_graph(g, {"input": window, "h0": h, "c0": h})
    cached = dict(g._torch_consts["cpu"])
    T.run_graph(g, {"input": window, "h0": h, "c0": h})
    assert g._torch_consts["cpu"].keys() == cached.keys()
    assert all(g._torch_consts["cpu"][k] is v for k, v in cached.items())


# -- Silero through the port's wrapper ------------------------------------------------


def test_silero_vad_matches_torch_and_jax_over_stream(tiny_silero):
    from stt_tpu.ops.silero import SileroVad as JSilero
    from stt_tpu_torch.ops.silero import SileroVad

    model, path = tiny_silero
    vad = SileroVad.from_onnx(path, device="cpu")
    jvad = JSilero.from_onnx(path)
    assert vad.context_samples == 64 and vad.state_names == ["h0", "c0"]
    rng = np.random.default_rng(8)
    states, jstates = vad.init_state(1), jvad.init_state(1)
    th = tc = torch.zeros(1, 1, 24)
    for _ in range(4):
        window = rng.normal(0, 0.3, 576).astype(np.float32)
        prob, states = vad.score(window[None, :], states)
        jprob, jstates = jvad.score(window[None, :], jstates)
        with torch.no_grad():
            tprob, th, tc = model(torch.from_numpy(window[None, :]), th, tc)
        assert abs(prob - float(tprob[0, 0])) < 1e-4
        assert abs(prob - jprob) < ATOL
        assert all(s.device.type == "cpu" and torch.is_tensor(s) for s in states)


def test_silero_session_carries_context_and_state(tiny_silero):
    from stt_tpu.ops.silero import SileroVad as JSilero
    from stt_tpu.ops.silero import SileroVadSession as JSession
    from stt_tpu_torch.ops.silero import SileroVad, SileroVadSession

    model, path = tiny_silero
    session = SileroVadSession(SileroVad.from_onnx(path, device="cpu"))
    frames = np.random.default_rng(9).normal(0, 0.3, (5, 512)).astype(np.float32)
    probs = session.score(frames)
    th = tc = torch.zeros(1, 1, 24)
    context = np.zeros(64, np.float32)
    for i in range(5):
        with torch.no_grad():
            tprob, th, tc = model(torch.from_numpy(np.concatenate([context, frames[i]])[None]),
                                  th, tc)
        assert abs(float(probs[i]) - float(tprob[0, 0])) < 1e-4
        context = frames[i][-64:]
    np.testing.assert_allclose(probs, JSession(JSilero.from_onnx(path)).score(frames),
                               atol=ATOL)
    session.reset()
    np.testing.assert_allclose(probs, session.score(frames), atol=1e-6)


class V5Silero(torch.nn.Module):
    """The published v5 signature: input [B, 576], one state [2, B, H],
    ``sr`` choosing the 16 kHz branch (an 8 kHz one scales the window)."""

    def __init__(self, hidden: int = 128):
        super().__init__()
        self.c1 = torch.nn.Conv1d(1, 32, 16, stride=8)
        self.lstm = torch.nn.LSTM(32, hidden)
        self.head = torch.nn.Linear(hidden, 1)

    def forward(self, x, state, sr: int = 16000):
        if sr != 16000:
            x = x * 0.5
        feats = torch.relu(self.c1(x.unsqueeze(1))).mean(-1)
        y, (h, c) = self.lstm(feats.unsqueeze(0), (state[0:1], state[1:2]))
        return torch.sigmoid(self.head(y[0])), torch.cat([h, c], dim=0)


def export_v5(model: V5Silero, path, hidden: int = 128) -> str:
    w, r, b = _lstm_onnx_weights(model.lstm)

    def branch(const, value):
        return graph([node("Mul", ["input", const], ["x_sr"])],
                     [_pb_tensor(const, np.asarray(value, np.float32))], [], ["x_sr"])

    if_attrs = attr_graph("then_branch", branch("one", 1.0))
    if_attrs += attr_graph("else_branch", branch("half", 0.5))
    g = graph(
        nodes=[
            node("Equal", ["sr", "sr16"], ["is16"]),
            node("If", ["is16"], ["x_sr"], if_attrs),
            node("Unsqueeze", ["x_sr", "one_ax"], ["x3"]),
            node("Conv", ["x3", "w1", "b1"], ["f1"],
                 attr_ints("strides", [8]) + attr_ints("kernel_shape", [16])),
            node("Relu", ["f1"], ["f2"]),
            node("ReduceMean", ["f2"], ["feat"], attr_ints("axes", [-1]) + attr_int("keepdims", 0)),
            node("Unsqueeze", ["feat", "zero_ax"], ["seq"]),
            node("Gather", ["state", "i0"], ["h0s"], attr_int("axis", 0)),
            node("Gather", ["state", "i1"], ["c0s"], attr_int("axis", 0)),
            node("Unsqueeze", ["h0s", "zero_ax"], ["h0"]),
            node("Unsqueeze", ["c0s", "zero_ax"], ["c0"]),
            node("LSTM", ["seq", "W", "R", "B", "", "h0", "c0"], ["y", "hn", "cn"],
                 attr_int("hidden_size", hidden)),
            node("Squeeze", ["y", "sq_ax"], ["y2"]),
            node("Gemm", ["y2", "hw", "hb"], ["logit"], attr_int("transB", 1)),
            node("Sigmoid", ["logit"], ["output"]),
            node("Concat", ["hn", "cn"], ["stateN"], attr_int("axis", 0)),
        ],
        initializers=[
            _pb_tensor("sr16", np.asarray(16000, np.int64)),
            _pb_tensor("one_ax", np.asarray([1], np.int64)),
            _pb_tensor("zero_ax", np.asarray([0], np.int64)),
            _pb_tensor("sq_ax", np.asarray([0, 1], np.int64)),
            _pb_tensor("i0", np.asarray(0, np.int64)),
            _pb_tensor("i1", np.asarray(1, np.int64)),
            _pb_tensor("w1", _np(model.c1.weight)), _pb_tensor("b1", _np(model.c1.bias)),
            _pb_tensor("W", w), _pb_tensor("R", r), _pb_tensor("B", b),
            _pb_tensor("hw", _np(model.head.weight)), _pb_tensor("hb", _np(model.head.bias)),
        ],
        inputs=[("input", (None, 576)), ("state", (2, None, hidden)), ("sr", ())],
        outputs=["output", "stateN"],
    )
    return write_model(path, g)


@pytest.mark.parametrize("sample_rate", [16000, 8000])
def test_v5_signature_scores_a_stream_like_torch_and_jax(tmp_path, sample_rate):
    from stt_tpu.ops.silero import SileroVad as JSilero
    from stt_tpu_torch.ops.silero import SileroVad, SileroVadSession

    torch.manual_seed(21)
    model = V5Silero().eval()
    path = export_v5(model, tmp_path / "v5.onnx")
    vad = SileroVad.from_onnx(path, sample_rate=sample_rate, device="cpu")
    assert vad.sr_name == "sr" and vad.state_names == ["state"] and vad.context_samples == 64
    assert vad.init_state(1)[0].shape == (2, 1, 128)
    frames = np.random.default_rng(22).normal(0, 0.3, (6, 512)).astype(np.float32)
    session = SileroVadSession(vad)
    probs = session.score(frames)
    assert session._states[0].shape == (2, 1, 128)      # the state keeps its rank
    jvad = JSilero.from_onnx(path, sample_rate=sample_rate)
    jstates, ctx, state = jvad.init_state(1), np.zeros(64, np.float32), torch.zeros(2, 1, 128)
    for i in range(6):
        window = np.concatenate([ctx, frames[i]])[None]
        jprob, jstates = jvad.score(window, jstates)
        with torch.no_grad():
            tprob, state = model(torch.from_numpy(window), state, sample_rate)
        assert abs(float(probs[i]) - jprob) < ATOL
        assert abs(float(probs[i]) - float(tprob[0, 0])) < 1e-4
        ctx = frames[i][-64:]


def test_vad_pool_creates_silero_sessions(tiny_silero):
    from stt_tpu_torch.ops.silero import SileroVadSession
    from stt_tpu_torch.server.component.vad_gate import VADGate, VADModelPool

    _, path = tiny_silero
    pool = VADModelPool()
    pool.set_silero_model(path, device="cpu")
    session = pool.acquire_model()
    assert isinstance(session, SileroVadSession)
    gate = VADGate(vad_threshold=0.5, vad_silence=0.1, model_pool=pool)
    update = gate.update(np.zeros(1600, np.int16).tobytes(), 16000)
    assert 0.0 <= update.silence_duration
    gate.close()

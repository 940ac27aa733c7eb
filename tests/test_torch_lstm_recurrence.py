"""ops/lstm.BiLSTM, the listener's float32 BiLSTM as one autograd.Function,
on the CPU, where its recurrence is the plain PyTorch version of the CUDA
kernel pair (csrc/lstm_recurrence.cu; the card tests are in
tests/test_torch_cuda.py):

- its forward and its written-out backward against nn.LSTM and autograd:
  the output and the gradients of the input, weight_ih, weight_hh and
  bias_ih of both directions, in float64 to 1e-10 and in float32 to
  float32 rounding; bias_hh, the zero buffer, takes no gradient;
- the dispatch: a float32 LSTM takes BiLSTM (the kernels on a CUDA
  tensor, the plain version on a CPU one), a tanh RNN and a bf16 LSTM
  nn.RNN's own; the kernels' wrapper refuses a CPU tensor;
- the profiler range `las.listener.rnn` around each BiRNN call (cnn,
  pblstm, tanh, LSTM, tensor-parallel), nothing recorded without a
  profiler, and the Function's backward node among the host ops that the
  benchmark's reader (bench_torch/drivers/train_loader_rnn) ties to it.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import types

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.models import las
from automatic_speech_recognition_torch.ops import layers, lstm
from automatic_speech_recognition_torch.parallel import tensor_parallel as tp
from automatic_speech_recognition_torch.utils import spans
from bench_torch.drivers import train_loader_rnn

CPU = torch.device("cpu")
TRAINED = ("weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
           "weight_ih_l0_reverse", "weight_hh_l0_reverse",
           "bias_ih_l0_reverse")


def _lstm(d_in, units, dtype, seed=0):
    rnn = layers.make_birnn(d_in, units, "lstm").to(dtype)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in rnn.parameters():
            p.copy_(torch.randn(p.shape, generator=g, dtype=dtype))
    return rnn


def _grads(out, x, rnn, dout):
    leaves = [x] + [getattr(rnn, n) for n in TRAINED]
    return (out,) + torch.autograd.grad(out, leaves, dout)


@pytest.mark.parametrize("dtype,rows,steps", [
    (torch.float64, 1, 1), (torch.float64, 3, 7), (torch.float32, 1, 1),
    (torch.float32, 3, 7)])
def test_lstm_recurrence_plain_matches_torch_lstm(dtype, rows, steps):
    """float64 to 1e-10; float32 to rtol 1e-5 / atol 2e-6 (the same sums
    in another order)."""
    rnn = _lstm(5, 4, dtype)
    g = torch.Generator().manual_seed(rows * 10 + steps)
    x = torch.randn(rows, steps, 5, generator=g, dtype=dtype,
                    requires_grad=True)
    dout = torch.randn(rows, steps, 8, generator=g, dtype=dtype)
    out = layers.birnn_apply(rnn, x)
    assert type(out.grad_fn).__name__ == "BiLSTMBackward"
    got = _grads(out, x, rnn, dout)
    want = _grads(rnn(x)[0], x, rnn, dout)
    tol = (dict(rtol=0, atol=1e-10) if dtype == torch.float64
           else dict(rtol=1e-5, atol=2e-6))
    for name, a, b in zip(("out", "x") + TRAINED, got, want):
        torch.testing.assert_close(a, b, **tol, msg=name)


def test_bias_hh_takes_no_gradient():
    rnn = _lstm(3, 4, torch.float32)
    x = torch.randn(2, 5, 3)
    layers.birnn_apply(rnn, x).square().sum().backward()
    for name in ("bias_hh_l0", "bias_hh_l0_reverse"):
        buf = getattr(rnn, name)
        assert name in rnn._buffers and not buf.requires_grad
        assert buf.grad is None and not buf.any()
    assert all(getattr(rnn, n).grad is not None for n in TRAINED)


def test_dispatch_by_what_the_input_shows():
    lstm_rnn = layers.make_birnn(3, 4, "lstm")
    tanh_rnn = layers.make_birnn(3, 4, "rnn")
    card = types.SimpleNamespace(is_cuda=True, dtype=torch.float32)
    card_bf16 = types.SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)
    card_f64 = types.SimpleNamespace(is_cuda=True, dtype=torch.float64)
    assert lstm.route(lstm_rnn, card) == "bilstm"
    assert lstm.route(lstm_rnn, card_bf16) == "library"
    assert lstm.route(lstm_rnn, card_f64) == "library"
    assert lstm.route(tanh_rnn, card) == "library"
    x = torch.randn(2, 5, 3)
    assert lstm.route(lstm_rnn, x) == "bilstm"
    assert lstm.route(lstm_rnn, x.double()) == "bilstm"
    assert lstm.route(lstm_rnn, x.bfloat16()) == "library"
    assert lstm.route(tanh_rnn, x) == "library"
    kinds = {"lstm": lstm_rnn, "tanh": tanh_rnn,
             "bf16": layers.make_birnn(3, 4, "lstm").to(torch.bfloat16)}
    names = {k: type(layers.birnn_apply(
        rnn, x.requires_grad_().to(next(rnn.parameters()).dtype)
    ).grad_fn).__name__ for k, rnn in kinds.items()}
    assert names["lstm"] == "BiLSTMBackward"
    assert names["tanh"] != "BiLSTMBackward"
    assert names["bf16"] != "BiLSTMBackward"


def test_kernel_wrapper_refuses_a_cpu_tensor_and_counts_nothing():
    B, T, U = 2, 3, 4
    state = [torch.zeros(B, T, 2 * U) for _ in range(2)]
    w = torch.zeros(4 * U, U)
    with pytest.raises(ValueError, match="CUDA"):
        lstm.recurrence_forward(torch.zeros(B, T, 8 * U), *state, (w, w))
    with pytest.raises(ValueError, match="CUDA"):
        lstm.recurrence_backward(torch.zeros(B, T, 8 * U), state[0],
                                 torch.zeros(B, T, 8 * U), state[1], (w, w))
    totals = spans.totals()
    layers.birnn_apply(layers.make_birnn(3, U, "lstm"), torch.randn(B, T, 3))
    assert layers.KERNEL_FRAMES not in spans.report(
        totals, (layers.KERNEL_FRAMES,))


def _split(rnn):
    """rnn with every weight split over two CPU positions (rows)."""
    dims = {n: 0 for n in rnn._flat_weights_names}
    return tp.shard_(rnn, dims, tp.DeviceAxis([CPU, CPU]))


def _listener_ranges(kind):
    """(calls of the range while `kind`'s BiRNNs run under a CPU
    profiler, the calls expected)."""
    torch.manual_seed(0)
    if kind in ("tp_lstm", "tp_tanh"):
        cell = "lstm" if kind == "tp_lstm" else "rnn"
        rnn = layers.make_birnn(6, 4, cell)
        x = torch.randn(2, 5, 6)
        want = layers.birnn_apply(rnn, x)
        _split(rnn)
        assert tp.axis_of(rnn) is not None
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            out = layers.birnn_apply(rnn, x)
        torch.testing.assert_close(out, want, rtol=1e-6, atol=1e-6)
        calls = 1
    else:
        enc_type, cell, layers_n = {"cnn": ("cnn", "rnn", 6),
                                    "cnn_lstm": ("cnn", "lstm", 6),
                                    "pblstm": ("pblstm", "rnn", 2),
                                    "pblstm_lstm": ("pblstm", "lstm", 2)
                                    }[kind]
        cfg = Config(feat_dim=8, enc_type=enc_type, enc_units=4,
                     num_enc_channels=2, num_enc_layers=layers_n,
                     apply_bn=False, rnn_cell=cell)
        listener = (las.Listener(cfg) if enc_type == "cnn"
                    else las.PBLSTMListener(cfg))
        feats = torch.randn(2, 16, 8, 3)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            listener(feats, torch.tensor([16, 11]))
        calls = layers_n if enc_type == "cnn" else layers_n + 1
    got = sum(e.name == layers.RNN_RANGE for e in prof.events())
    return got, calls


@pytest.mark.parametrize("kind", ["cnn", "cnn_lstm", "pblstm",
                                  "pblstm_lstm", "tp_lstm", "tp_tanh"])
def test_the_range_opens_once_a_birnn_call_under_a_profiler(kind):
    got, calls = _listener_ranges(kind)
    assert got == calls


def test_the_range_records_nothing_without_a_profiler():
    assert not spans.profiling()
    assert spans.fine(layers.RNN_RANGE) is spans.fine("anything")
    records, _ = spans.snapshot()
    before = sum(r.name == layers.RNN_RANGE for r in records)
    for cell in ("lstm", "rnn"):
        layers.birnn_apply(layers.make_birnn(3, 4, cell),
                           torch.randn(2, 5, 3))
    records, _ = spans.snapshot()
    assert sum(r.name == layers.RNN_RANGE for r in records) == before
    assert layers.RNN_RANGE not in spans.totals()


def test_the_benchmark_ties_the_functions_backward_node_to_the_range():
    """train_loader_rnn.range_owners (the reader behind
    listener.lstm_roofline) counts the BiLSTM op and the projection under
    the range as forward, and the Function's backward node, with the ops
    under it, as backward."""
    rnn = _lstm(6, 4, torch.float32)
    x = torch.randn(2, 5, 6, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        layers.birnn_apply(rnn, x).square().sum().backward()
    events = list(prof.profiler.kineto_results.events())
    owners = train_loader_rnn.range_owners(events)
    host = train_loader_rnn._host_ops(events)
    node = [e for e in host if e.name() == train_loader_rnn.BACKWARD
            + "BiLSTMBackward"]
    assert len(node) == 1
    assert owners[node[0].correlation_id()] == "backward"
    under = [e for e in host if e.start_ns() > node[0].start_ns()
             and e.end_ns() <= node[0].end_ns()
             and e.start_thread_id() == node[0].start_thread_id()]
    assert any(e.name() == "aten::mm" for e in under)
    assert all(owners.get(e.correlation_id()) == "backward" for e in under)
    forward = [e for e in host if e.name() in ("BiLSTM", "aten::addmm")]
    assert {e.name() for e in forward} == {"BiLSTM", "aten::addmm"}
    assert all(owners[e.correlation_id()] == "forward" for e in forward)

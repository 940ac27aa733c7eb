"""The LSTM LAS's reference module (reference/las_lstm.py) and its cell:
its parameter spec loads strictly into the port's model at a tiny size
and at LAS-6-1280's published widths (230.7 M parameters, the count the
configuration file states); its operation counts against a hand count
and against torch's FLOP counter; the listener's recurrences' operations
and bytes; the new cell through its driver at a tiny size, with its
per-layer readers; the reader of the recurrences' device time, on made-up
profiles and on the CPU profiler's events of a BiLSTM layer run by
cuDNN's module, a custom autograd.Function and a loop of cells, and
against cuDNN's ops on the card."""

import math

import pytest

import torch
from torch.utils.flop_counter import FlopCounterMode

from bench_torch import harness, weights, work
from bench_torch.harness import ROOT, load_json
from bench_torch.reference import las_lstm as ref
from bench_torch.tests import tiny
from bench_torch.tests.test_run import train_run

CONFIG = load_json(ROOT / "bench_torch/configs/las_6_1280_park2019.json")
PARK = CONFIG["values"]
CELL = "las_6_1280_park2019.train_wpm"
TINY = dict(vocab_size=11, feat_dim=5, num_enc_channels=3, enc_units=6,
            num_enc_layers=2, attention_size=4, loc_kernel_size=5,
            loc_num_channels=2, dec_units=7, embedding_size=3)


def test_spec_loads_strictly_at_tiny_and_published_widths():
    from automatic_speech_recognition_torch.models.las import LAS, num_params
    c = dict(PARK, **TINY)
    w = weights.make(ref.param_spec(c), 1, torch.device("cpu"))
    model = harness.build_model(harness.program_config(c), w,
                                torch.device("cpu"))
    assert model.speller.lstm
    assert isinstance(model.listener.layers[0].birnn, torch.nn.LSTM)
    with torch.device("meta"):
        model = LAS(harness.program_config(PARK))
    spec = {n: s for n, s, _ in ref.param_spec(PARK)}
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == spec
    assert num_params(model) == CONFIG["parameters"] == 230_677_408
    listener = sum(p.numel() for n, p in model.named_parameters()
                   if n.startswith("listener."))
    assert round(listener / 1e6, 1) == 170.5
    assert model.speller.out.weight.numel() == 1280 * 16384


def hand_count(c, frames, steps):
    """model_flops of the tiny cnn config, written out term by term."""
    half = lambda n: (n + 1) // 2
    t1, d1 = half(frames), half(c["feat_dim"])
    t2, d2 = half(t1), half(d1)
    C, u = c["num_enc_channels"], c["enc_units"]
    conv = 2 * t1 * d1 * C * 3 * 9 + 2 * t2 * d2 * C * C * 9
    lstm, d = 0, d2 * C
    for _ in range(c["num_enc_layers"]):
        lstm += 2 * 2 * t2 * 4 * u * (d + u) + 2 * t2 * 2 * u * u
        d = u
    A, U, L, E, V = (c["attention_size"], c["dec_units"], c["num_dec_layers"],
                     c["embedding_size"], c["vocab_size"])
    att = 2 * L * U * A + 3 * t2 * A + 3 * t2 + 2 * t2 * u
    cells = 2 * (E + u + U) * 4 * U + 2 * (U + U) * 4 * U
    return conv + lstm + 2 * t2 * u * A + steps * (att + cells + 2 * U * V)


def test_counts_against_a_hand_count_and_torch_flop_counter():
    c = dict(PARK, **TINY)
    assert ref.model_flops(c, 37, 9) == hand_count(c, 37, 9)
    w = weights.make(ref.param_spec(c), 3, torch.device("cpu"))
    feats = torch.randn(2, 41, c["feat_dim"], 3)
    with FlopCounterMode(display=False) as fc:
        ref.listen(w, c, feats, torch.tensor([41, 30]))
    assert fc.get_total_flops() == 2 * ref.listener_flops(c, 41)
    # a BiLSTM's forward and backward (the input's and the weights'
    # gradients) against rnn_work's count of the listener's recurrences
    leaves = {k: v.clone().requires_grad_() for k, v in w.items()}
    total = 0
    for i, (t, d) in enumerate(ref._birnn_layers(c, 41)):
        x = torch.randn(2, t, d, requires_grad=True)
        with FlopCounterMode(display=False) as fc:
            ref._bilstm(leaves, f"listener.layers.{i}.birnn", x).sum(
            ).backward()
        total += fc.get_total_flops()
    # autograd skips the gradient to each direction's zero initial state
    u, layers = c["enc_units"], len(ref._birnn_layers(c, 41))
    skipped = layers * 2 * (2 * 2 * 4 * u * u)
    assert total == ref.rnn_work(c, 2, 41)[0] - skipped


def test_rnn_work_and_frames_at_the_published_shape():
    # the widest bucket: 48 rows of 1,706 frames, 427 steps a BiLSTM
    ops, nbytes = ref.rnn_work(PARK, 48, 1706)
    layers = ref._birnn_layers(PARK, 1706)
    assert layers == [(427, 640)] + [(427, 1280)] * 5
    assert ops == 3 * 48 * sum(2 * 427 * 2 * 4 * 1280 * (d + 1280)
                               for _, d in layers)
    w_hh = 2 * 6 * 2 * 427 * 4 * 1280 * 1280 * 4    # read a step, both ways
    assert w_hh < nbytes < 1.2 * w_hh
    # FLOP-bound: 18.5 TFLOP at float32's 67 TFLOP/s against 286 GB
    assert ops / work.peak(PARK) > 3 * nbytes / work.HBM_BYTES_PER_S
    assert ref.rnn_frames(PARK, 1706) == 6 * 2 * 427
    # 22.0 TFLOP in the widest bucket's step of 64 decoder steps a row
    step = 3 * 48 * ref.model_flops(PARK, 1706, 64)
    assert math.isclose(step / 1e12, 22.02, abs_tol=0.01)


def test_the_cell_through_its_driver_at_a_tiny_size():
    run = train_run(CELL, trace=1)
    res = tiny.execute(run)
    assert res["correct"] is True, res
    assert run.config["values"]["rnn_cell"] == "lstm"
    assert run.counters["listener.rnn_frames"] > run.counters[
        "listener.real_frames"] > 0
    pad = res["metrics"]["listener.rnn_pad_pct"]["value"]
    assert 0 < pad < 100
    assert {"mfu.train", "speller.forward_ms_per_step",
            "train.unspanned_pct"} <= set(res["metrics"])
    # the CPU has no device trace: the roofline is left out
    assert "listener.lstm_roofline" not in res["metrics"]
    assert "device.idle.train" not in res["metrics"]


def test_a_half_batch_in_the_cell_is_not_correct():
    res = tiny.execute(train_run(CELL, faults=("half_batch",)))
    assert res["correct"] is False, res


def test_roofline_reader_from_a_traced_record():
    """The reader's arithmetic on a made-up trace: two traced steps of the
    widest bucket, their recurrences' device time twice their least."""
    run = train_run(CELL)
    run.config = dict(run.config, values=PARK)
    run.span("frontend.traced", 48, 273_040, 1706)
    run.span("frontend.traced", 48, 273_040, 1706)
    ops, _ = ref.rnn_work(PARK, 48, 1706)
    least = ops / work.peak(PARK)
    run.traced = {"rnn_device_s": {"forward": least, "backward": 3 * least}}
    reader = harness.load_module(harness.HERE / "metrics"
                                 / "listener.lstm_roofline.py")
    assert math.isclose(reader.read(run), 50.0)
    run.traced = {"rnn_device_s": {"forward": 0.0, "backward": 0.0}}
    assert reader.read(run) is None


def raw_event(corr, name, start, end, thread=1, seq=-1, fwd_thread=0,
              linked=0, device=False, annotation=False):
    """A stand-in for one of the profiler's raw (kineto) events."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType
    fields = dict(
        correlation_id=corr, name=name, start_ns=start, end_ns=end,
        start_thread_id=thread, sequence_nr=seq, fwd_thread_id=fwd_thread,
        linked_correlation_id=linked, is_async=False,
        is_user_annotation=annotation,
        device_type=DeviceType.CUDA if device else DeviceType.CPU)
    return NS(**{k: (lambda v=v: v) for k, v in fields.items()})


def cudnn_profile():
    """No program range: cuDNN's RNN forward (1, holding a copy, 3, and a
    runtime call whose own id, 4, is another op's) and backward (2, on the
    autograd thread), and a matmul of another layer (4)."""
    return [raw_event(1, "aten::_cudnn_rnn", 0, 100),
            raw_event(3, "aten::copy_", 10, 20),
            raw_event(4, "cudaLaunchKernel", 30, 31, linked=1),
            raw_event(2, "aten::_cudnn_rnn_backward", 200, 300, thread=2),
            raw_event(4, "aten::mm", 400, 500)]


def range_profile():
    """The program's range (10) around a recurrence: a custom op (1, seq
    5; a runtime call under it has the id 8 of another op) and a fill (3)
    that records seq 6 and makes no node; then another layer's matmul (4)
    outside it, which makes node 6.  The backward, on another thread: the
    matmul's node 6 (8), the recurrence's node 5 (11) with its op (2)
    under it, an AccumulateGrad (9, seq -1)."""
    from bench_torch.drivers.train_loader_rnn import BACKWARD, RANGE
    return [raw_event(10, RANGE, 10, 19, annotation=True),
            raw_event(1, "Rec", 11, 15, seq=5),
            raw_event(8, "cudaLaunchKernel", 12, 13, linked=1),
            raw_event(3, "aten::fill_", 16, 18, seq=6),
            raw_event(4, "aten::mm", 20, 25, seq=6),
            raw_event(8, BACKWARD + "MmBackward0", 30, 35, thread=2, seq=6,
                      fwd_thread=1),
            raw_event(11, BACKWARD + "RecBackward", 40, 50, thread=2, seq=5,
                      fwd_thread=1),
            raw_event(2, "RecBackward", 41, 49, thread=2, seq=5,
                      fwd_thread=1),
            raw_event(9, BACKWARD + "torch::autograd::AccumulateGrad", 55,
                      60, thread=2)]


@pytest.mark.parametrize("profile", [cudnn_profile, range_profile])
def test_op_device_time_is_the_union_of_the_ops_kernels(profile):
    """rnn_device_s on a made-up profile: the recurrences' kernels, found
    by the linked correlation id of a host op of theirs, forward and
    backward, each as the union of their intervals (two directions side
    by side count once); a kernel of another layer's op or node, a range
    annotation on the device, and the kernels of an op whose id a runtime
    call under the recurrence carries are left out.  With the program's
    range, its ops and the nodes they made; without one, cuDNN's two RNN
    ops."""
    from bench_torch.drivers.train_loader_rnn import rnn_device_s
    kernels = [(1, 0, 4_000), (1, 1_000, 5_000), (3, 6_000, 7_000),
               (2, 10_000, 13_000), (4, 20_000, 90_000), (8, 0, 50_000),
               (9, 0, 60_000)]
    events = profile() + [raw_event(0, "kernel", a, b, linked=op, device=True)
                          for op, a, b in kernels] + [
        raw_event(0, "range on the device", 0, 99_000, linked=1, device=True,
                  annotation=True)]
    assert rnn_device_s(events) == {"forward": 6e-6, "backward": 3e-6}


def cell_loop(xs, weights):
    """A bidirectional LSTM as a plain loop of the port's fused cell
    (layers.lstm_cell_apply) over both directions: (B, T, D) -> (B, T, 2U)."""
    import torch.nn.functional as F
    from automatic_speech_recognition_torch.ops import layers
    outs = []
    for (w, b), steps in zip((weights[:2], weights[2:]),
                             (range(xs.shape[1]), reversed(range(xs.shape[1])))):
        h = c = xs.new_zeros(xs.shape[0], w.shape[0] // 4)
        hs = {}
        for t in steps:
            h, (c, _) = layers.lstm_cell_apply(
                lambda z: F.linear(z, w, b), xs[:, t], (c, h))
            hs[t] = h
        outs.append(torch.stack([hs[t] for t in sorted(hs)], 1))
    return torch.cat(outs, -1)


class HandRecurrence(torch.autograd.Function):
    """A stand-in for a hand-written recurrence: a forward that leaves no
    graph and a backward of its own, which runs the loop again and takes
    its gradients."""

    @staticmethod
    def forward(ctx, xs, *weights):
        ctx.save_for_backward(xs, *weights)
        return cell_loop(xs, weights)

    @staticmethod
    def backward(ctx, grad):
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in ctx.saved_tensors]
            return torch.autograd.grad(cell_loop(leaves[0], leaves[1:]),
                                       leaves, grad)


def recurrence(kind: str, d: int, u: int):
    """(the parameters, xs -> (B, T, 2U)) of a BiLSTM of `kind`."""
    from automatic_speech_recognition_torch.ops import layers
    if kind == "nn.LSTM":
        rnn = layers.make_birnn(d, u, "lstm")
        return list(rnn.parameters()), lambda xs: layers.birnn_apply(rnn, xs)
    weights = [torch.nn.Parameter(torch.randn(*shape) * 0.3)
               for _ in range(2) for shape in ((4 * u, d + u), (4 * u,))]
    if kind == "function":
        def hand(xs):
            out = HandRecurrence.apply(xs, *weights)
            # bookkeeping after the kernel, as a launcher may do: an op on
            # tensors that need no gradient records the number of the
            # next node made (the projection's) and makes none
            torch.ones(1) * xs.shape[1]
            return out
        return weights, hand
    return weights, lambda xs: cell_loop(xs, weights)


def node_numbers(root, stop=None) -> set:
    """Sequence numbers of the autograd nodes reachable from `root`, not
    through `stop`, AccumulateGrad left out."""
    seen, todo = {}, [root]
    while todo:
        n = todo.pop()
        if n is None or n is stop or id(n) in seen:
            continue
        seen[id(n)] = n
        todo.extend(f for f, _ in n.next_functions)
    return {n._sequence_nr() for n in seen.values()
            if "AccumulateGrad" not in type(n).__name__}


@pytest.mark.parametrize("kind", ["nn.LSTM", "function", "cell loop"])
def test_reader_owns_the_recurrence_and_nothing_else(kind):
    """One listener layer (a BiLSTM under the program's range, its 2U -> U
    projection, training batch norm, ReLU) with a loss, its backward and
    an Adam step, profiled on the CPU: the reader's events are exactly
    those under the range and those under the backward nodes that the
    recurrence's forward made, for cuDNN's module, a custom
    autograd.Function and an eager cell loop alike; no event of the
    projection, batch norm, loss, optimizer or an AccumulateGrad."""
    from automatic_speech_recognition_torch.ops import layers
    from bench_torch.drivers.train_loader_rnn import (
        BACKWARD, RANGE, recurrence_owners)
    from torch.profiler import ProfilerActivity, profile, record_function
    torch.manual_seed(0)
    b, t, d, u = 2, 5, 3, 4
    params, rnn = recurrence(kind, d, u)
    proj = torch.nn.Linear(2 * u, u)
    scale, bias = torch.ones(u, requires_grad=True), torch.zeros(
        u, requires_grad=True)
    opt = torch.optim.Adam(params + list(proj.parameters()) + [scale, bias])
    x0 = torch.randn(b, t, d, requires_grad=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = x0 * 2.0
        with record_function(RANGE):
            out = rnn(x)
        with record_function("layer.rest"):
            y, _ = layers.bn_train(proj(out), scale, bias, torch.zeros(u),
                                   torch.ones(u))
            loss = torch.relu(y).square().mean()
        loss.backward()
        with record_function("layer.optimizer"):
            opt.step()
    owner = recurrence_owners(list(prof.profiler.kineto_results.events()))
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CPU]

    def subtree(e):
        return [e] + [s for c in e.cpu_children for s in subtree(c)]

    def in_node(e):
        while e.cpu_parent is not None:
            e = e.cpu_parent
            if e.name.startswith(BACKWARD):
                return True
        return False

    # what the reader should find, from the event tree and the graph
    nodes = [e for e in events if e.name.startswith(BACKWARD)
             and not in_node(e)]
    mine = node_numbers(out.grad_fn, stop=x.grad_fn)
    others = node_numbers(loss.grad_fn) - mine
    forward = {s.id for r in events if r.name == RANGE for s in subtree(r)}
    linked = [n for n in nodes if n.sequence_nr in mine]
    backward = {s.id for n in linked for s in subtree(n)}
    assert owner == {**{i: "forward" for i in forward},
                     **{i: "backward" for i in backward}}
    assert linked and len(forward) > 1
    assert {n.sequence_nr for n in nodes} & others
    assert not [n.name for n in nodes if n.id in owner and (
        n.sequence_nr in others or "AccumulateGrad" in n.name)]
    rest = [s for r in events if r.name in ("layer.rest", "layer.optimizer")
            for s in subtree(r)]
    assert rest and not [s.name for s in rest if s.id in owner]


@pytest.mark.parametrize("shape", [(16, 100, 256, 256), (48, 427, 1280, 1280)],
                         ids=["small", "widest_bucket"])
def test_range_reading_equals_cudnn_ops_on_the_card(shape):
    """On the card, a cuDNN BiLSTM layer (small, and the cell's widest
    bucket: 48 rows, 427 steps, 1280 wide) under the program's range,
    forward and backward under the harness's profiler: the range's reading
    holds the cuDNN ops' reading of the same profile and exceeds it by 2 %
    at most (the zero states' fills), forward and backward alike.  Runs on
    a host with a GPU (python3 -m pytest bench_torch/tests/test_las_lstm.py
    -k card); skips elsewhere."""
    if not torch.cuda.is_available():
        pytest.skip("cuDNN's RNN runs on the GPU only")
    from automatic_speech_recognition_torch.ops import layers
    from bench_torch.drivers.train_loader_rnn import (
        RANGE, cudnn_owners, rnn_device_s)
    from bench_torch.trace import Stretch
    b, t, d, u = shape
    dev = torch.device("cuda")
    rnn = layers.make_birnn(d, u, "lstm").to(dev)
    proj = torch.nn.Linear(2 * u, u).to(dev)
    x0 = torch.randn(b, t, d, device=dev, requires_grad=True)

    def step():
        x = x0 * 2.0
        with torch.profiler.record_function(RANGE):
            out = layers.birnn_apply(rnn, x)
        proj(out).square().mean().backward()

    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False      # float32, as the cell runs
    try:
        step()
        with Stretch() as s:
            step()
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    events = list(s.prof.profiler.kineto_results.events())
    new = rnn_device_s(events)
    old = rnn_device_s(events, cudnn_owners(events))
    print(torch.cuda.get_device_name(), shape, "range", new, "cudnn ops", old)
    for key in ("forward", "backward"):
        assert 0 < old[key] <= new[key] <= 1.02 * old[key], (key, new, old)

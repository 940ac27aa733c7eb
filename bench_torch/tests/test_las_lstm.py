"""The LSTM LAS's reference module (reference/las_lstm.py) and its cell:
its parameter spec loads strictly into the port's model at a tiny size
and at LAS-6-1280's published widths (230.7 M parameters, the count the
configuration file states); its operation counts against a hand count
and against torch's FLOP counter; the listener's recurrences' operations
and bytes; the new cell through its driver at a tiny size, with its
per-layer readers."""

import math

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
    run.traced = {"op_device_s": {"aten::_cudnn_rnn": least,
                                  "aten::_cudnn_rnn_backward": 3 * least}}
    reader = harness.load_module(harness.HERE / "metrics"
                                 / "listener.lstm_roofline.py")
    assert math.isclose(reader.read(run), 50.0)
    run.traced = {"op_device_s": {}}
    assert reader.read(run) is None


def test_op_device_time_is_the_union_of_the_ops_kernels():
    """op_device_s on a made-up profile: each RNN op's kernels, found by
    the correlation id of the op or of an op under it, as the union of
    their intervals (two directions side by side count once); a kernel of
    another op and a range annotation on the device are left out."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType
    from bench_torch.drivers.train_loader_rnn import RNN_OPS, op_device_s

    def op(id_, name, children=()):
        e = NS(id=id_, name=name, cpu_children=list(children),
               cpu_parent=None, device_type=DeviceType.CPU,
               is_user_annotation=False)
        for c in children:
            c.cpu_parent = e
        return e

    def kernel(linked, start, end, annotation=False):
        return NS(linked_correlation_id=lambda: linked,
                  device_type=lambda: DeviceType.CUDA,
                  is_user_annotation=lambda: annotation,
                  start_ns=lambda: start, end_ns=lambda: end)

    copy = op(3, "aten::copy_")
    events = [op(1, "aten::_cudnn_rnn", [copy]), copy,
              op(2, "aten::_cudnn_rnn_backward"), op(4, "aten::mm")]
    kernels = [kernel(1, 0, 4_000), kernel(1, 1_000, 5_000),   # 2 directions
               kernel(3, 6_000, 7_000), kernel(2, 10_000, 13_000),
               kernel(4, 20_000, 90_000), kernel(1, 0, 99_000, True)]
    prof = NS(events=lambda: events, profiler=NS(
        kineto_results=NS(events=lambda: kernels)))
    got = op_device_s(prof, RNN_OPS)
    assert got == {"aten::_cudnn_rnn": 6e-6, "aten::_cudnn_rnn_backward": 3e-6}

"""The port's LSTM LAS (Config.rnn_cell 'lstm') against the plain
reference bench_torch/reference/las_lstm.py, which imports nothing of the
port, at a tiny size on the CPU: the same seeded weights (its param_spec,
loaded strictly into the port's model) and the same inputs through both.

- Teacher-forced logits and loss, and every leaf's gradient, agree to
  float32 rounding; so do three training steps (trainer.train_step on
  raw audio against the reference's train_steps): losses and each leaf's
  change.
- Greedy LAS.forward's logits are the reference's forced logits of the
  greedy tokens; beam search at K = 1 gives greedy's tokens, and at K = 3
  the best hypothesis' summed log-probabilities are the reference's
  forced log-probabilities of its tokens (the decoder's (h, c) follow
  their beam).
- Tensor parallelism: a train step over two gloo processes at
  num_partitions 2, and greedy and beam over a split replica on two CPU
  positions, equal one process.
- bf16 compute_cast covers nn.LSTM's parameters and zero bias_hh
  buffers; int8 quantize_decoder quantizes the 4U-gate cells.
- The JAX conversions refuse rnn_cell 'lstm'; rnn_cell 'rnn' keeps every
  state-dict key and shape (the tanh reference's param_spec); an unknown
  cell is refused; init is glorot over the fused [x, h] kernel with
  fan_out 4U and zero biases.
"""

import math
import os

import numpy as np
import pytest
import torch

from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch.config import Config, parse_args
from automatic_speech_recognition_torch.decoding import beam
from automatic_speech_recognition_torch.models import convert, las
from automatic_speech_recognition_torch.ops import quant
from automatic_speech_recognition_torch.parallel import workers
from automatic_speech_recognition_torch.parallel.mesh import make_mesh
from automatic_speech_recognition_torch.training import trainer
from bench_torch import harness, weights
from bench_torch.reference import las as tanh_ref
from bench_torch.reference import las_lstm as ref

from test_torch_distributed import _finish, _retrying, _spawn
from test_torch_train_cli import _args as cli_args
from test_torch_train_cli import _shards as cli_shards

CPU = torch.device("cpu")
VALUES = dict(sample_rate=16000, frame_length=25, frame_step=10,
              fft_length=512, num_mel_filters=8, feat_type="fbank",
              feat_dim=8, cmvn=True, enc_type="cnn", enc_units=8,
              num_enc_channels=2, num_enc_layers=2, apply_bn=False,
              rnn_cell="lstm", mode="loc", attention_size=6,
              loc_kernel_size=5, loc_num_channels=2, dec_units=8,
              num_dec_layers=2, embedding_size=4, vocab_size=20, ctc=False,
              label_smoothing=True, lr=1e-3, grad_clip=5.0,
              dropout_rate=0.0, add_vn=False, scheduled_sampling=False,
              spec_augment=False, audio_shards=True, unit="char",
              convert_rate=0.5, dtype="float32")


def values(**kw):
    return dict(VALUES, **kw)


def model_and_weights(v, seed=0):
    w = weights.make(ref.param_spec(v), seed, CPU)
    cfg = harness.program_config(v)
    return harness.build_model(cfg, w, CPU), w, cfg


def inputs(v, seed=1, B=2, T=30, L=6):
    """Features (B, T, D, 3), their lengths and labels with a PAD tail."""
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(B, T, v["feat_dim"], 3, generator=g)
    featlen = torch.tensor([T, T - 7][:B], dtype=torch.int32)
    y = torch.randint(3, v["vocab_size"], (B, L), generator=g,
                      dtype=torch.int32)
    y[1, L - 2:] = 0
    return feats, featlen, y


def gap(a, b):
    """Largest difference over the larger of the reference's largest
    magnitude and 1e-3."""
    a, b = a.detach(), b.detach()
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-3)


@pytest.mark.parametrize("enc_type", ["cnn", "pblstm"])
def test_teacher_forced_logits_loss_and_gradients(enc_type):
    v = values(enc_type=enc_type, apply_bn=enc_type == "cnn")
    model, w, cfg = model_and_weights(v)
    feats, featlen, y = inputs(v)
    model.train()
    logits, _, _, _, _ = las.las_forward(model, feats, featlen, cfg,
                                         y.shape[1], teacher=y)
    loss = las.attention_loss(logits, y, cfg)
    names = [n for n, p in model.named_parameters()]
    grads = torch.autograd.grad(loss, list(model.parameters()))

    leaves = {k: t.clone().requires_grad_(ref.trainable(k))
              for k, t in w.items()}
    enc, enc_len = ref.listen(leaves, v, feats, featlen, training=True)
    want_logits = ref.spell(leaves, v, enc, enc_len, y)
    want_loss = ref.sequence_loss(want_logits, y, v)
    assert gap(logits, want_logits) < 1e-5
    assert abs(loss.item() - want_loss.item()) < 1e-6 * abs(want_loss.item())
    want = torch.autograd.grad(want_loss, [leaves[n] for n in names])
    assert set(names) == {k for k in w if ref.trainable(k)}
    for n, a, b in zip(names, grads, want):
        assert gap(a, b) < 1e-4, n


def train_batches(v, n=3, B=2):
    rng = np.random.default_rng(5)
    out = []
    for _ in range(n):
        S = 4800
        lens = np.array([S, S - 900][:B], np.int32)
        audio = np.zeros((B, S), np.float32)
        for i, k in enumerate(lens):
            audio[i, :k] = 0.1 * rng.standard_normal(k)
        y = rng.integers(3, v["vocab_size"], (B, 7)).astype(np.int32)
        y[:, -1] = 2
        y[1, 5:] = 0
        out.append(tuple(map(torch.from_numpy, (
            audio, lens, y, (y != 0).sum(1).astype(np.int32)))))
    return out


def test_three_train_steps_follow_the_reference():
    v = values(apply_bn=True)
    model, w, cfg = model_and_weights(v)
    ts = trainer.TrainState(model.train(), trainer.make_optimizer(model, cfg),
                            0, torch.Generator().manual_seed(0))
    batches = train_batches(v)
    losses = [float(trainer.train_step(ts, b, cfg)["loss"]) for b in batches]
    got = ref.train_steps(w, v, [b[:3] for b in batches])
    np.testing.assert_allclose(losses, got["loss"], rtol=2e-6)
    # the train cell's rule (bench_torch/drivers/train_loader.leaf_gap):
    # leaves whose first gradient is under a thousandth of the median
    # leaf's (a bias a batch norm follows) move by round-off alone
    raw = got["raw_grad"]
    med_raw = float(np.median(list(raw.values())))
    kept = [n for n in raw if raw[n] >= 1e-3 * med_raw]
    assert {n for n in raw if n not in kept} <= {
        f"listener.{n}.bias" for n in ("conv0", "conv1", "layers.0.proj",
                                       "layers.1.proj", "layers.0.bn_extra",
                                       "layers.1.bn_extra")}
    med = float(np.median([got["change"][n] for n in kept]))
    with torch.no_grad():
        for n, p in model.named_parameters():
            if n in kept:
                want = got["change"][n]
                change = float((p - w[n]).norm())
                assert abs(change - want) <= 1e-4 * max(want, med), n


def test_greedy_and_beam_follow_the_reference():
    v = values()
    model, w, cfg = model_and_weights(v)
    feats, featlen, _ = inputs(v, B=2, T=40)
    steps = 8
    with torch.no_grad():
        logits, _, _ = model(feats, featlen, steps)
        tokens = logits.argmax(-1)
        enc, enc_len = ref.listen(w, v, feats, featlen)
        want = ref.spell(w, v, enc, enc_len, tokens)
    assert gap(logits, want) < 1e-5

    one = beam.beam_search(model, feats, featlen, cfg, steps, 1)
    for b in range(2):
        n = int(one.lengths[b, 0])
        greedy = tokens[b].numpy()
        limit = n
        for stop, extra in ((2, 1), (1, 0)):     # EOS ends it, SOS never comes
            hit = np.nonzero(greedy == stop)[0]
            if len(hit) and hit[0] + extra < limit:
                limit = int(hit[0]) + extra
        assert limit > 0
        np.testing.assert_array_equal(one.tokens[b, 0, :limit].numpy(),
                                      greedy[:limit])

    three = beam.beam_search(model, feats, featlen, cfg, steps, 3,
                             logprob=True, step_scores=True)
    # every kept hypothesis, not only the best: those whose parent slot
    # changed read the (h, c) their parent left
    for b in range(2):
        for k in range(3):
            n = int(three.lengths[b, k])
            toks = three.tokens[b:b + 1, k, :n]
            with torch.no_grad():
                lp = torch.log_softmax(ref.spell(w, v, enc[b:b + 1],
                                                 enc_len[b:b + 1], toks), -1)
            want = float(lp[0, torch.arange(n), toks[0]].sum())
            got = float(three.step_scores.attention[b, k, :n].sum())
            assert abs(got - want) <= 1e-5 * abs(want), (b, k)


def test_split_replica_greedy_and_beam_equal_one_device():
    v = values(beam_logprob=True)
    model, _, cfg = model_and_weights(v)
    feats, featlen, _ = inputs(v, B=2, T=40)
    mesh = make_mesh(devices=[CPU, CPU], num_partitions=2)
    want_logits, want = trainer.eval_forward(model, feats, featlen, cfg, 8)
    want_beam = beam.beam_search(model, feats, featlen, cfg, 8, 3,
                                 logprob=True)
    with workers.EvalPool(mesh, cfg, model, None, None) as pool:
        logits, y_hat = pool.run_split("greedy", (feats, featlen), steps=8)
        got = pool.run_split("beam", (feats, featlen), beam_size=3, steps=8)
    torch.testing.assert_close(logits, want_logits, rtol=1e-5, atol=1e-5)
    assert torch.equal(y_hat, want)
    assert torch.equal(got.tokens, want_beam.tokens)
    torch.testing.assert_close(got.scores, want_beam.scores, rtol=1e-5,
                               atol=1e-5)


_TP_WORKER = r"""
import sys
import torch
from automatic_speech_recognition_torch.parallel import distributed, sharding
from automatic_speech_recognition_torch.parallel.mesh import make_mesh
from automatic_speech_recognition_torch.training import trainer

inputs, out_path = sys.argv[1:3]
assert distributed.maybe_initialize("cpu") is True
data = torch.load(inputs, weights_only=False)
cpu, cfg = torch.device("cpu"), data["cfg"]
mesh = make_mesh(devices=[cpu], group=distributed.world_group(),
                 num_partitions=2)
ts = trainer.create_train_state(cfg, cpu, mesh.data_index,
                                mesh.shape["data"])
ts.model.load_state_dict(data["state"])
step_fn, ts, shard = trainer.make_mesh_train_step(mesh, ts, None, cfg)
m = step_fn(ts, shard(data["batch"]))
torch.save({"loss": m["loss"].item(), "grad_norm": m["grad_norm"].item(),
            "state": sharding.whole_state_dict(ts.model),
            "local": {n: tuple(p.shape)
                      for n, p in ts.model.named_parameters()}}, out_path)
distributed.barrier("done")
distributed.destroy()
"""


def test_train_step_at_num_partitions_2_equals_one_process(tmp_path):
    v = values(apply_bn=True, audio_shards=False)
    model, w, cfg = model_and_weights(v)
    feats, featlen, y = inputs(v, B=4, T=30)
    featlen = torch.tensor([30, 23, 30, 17], dtype=torch.int32)
    batch = (feats, featlen, y, (y != 0).sum(1).to(torch.int32))
    state = {k: t.clone() for k, t in model.state_dict().items()}

    def run(attempt):
        inp = str(tmp_path / f"in{attempt}.pt")
        torch.save({"cfg": cfg, "state": state, "batch": batch}, inp)
        _finish(_spawn(_TP_WORKER, lambda r: [
            inp, str(tmp_path / f"out{attempt}_{r}.pt")], 2))
        return [torch.load(tmp_path / f"out{attempt}_{r}.pt",
                           weights_only=False) for r in range(2)]

    outs = _retrying(run)
    ts = trainer.TrainState(model.train(), trainer.make_optimizer(model, cfg),
                            0, torch.Generator().manual_seed(0))
    m = trainer.train_step(ts, batch, cfg)
    U = v["enc_units"]
    for out in outs:
        assert out["local"]["listener.layers.0.birnn.weight_hh_l0"] == (
            4 * U // 2, U)
        assert out["local"]["speller.cells.1.weight"] == (
            4 * v["dec_units"] // 2, 2 * v["dec_units"])
        assert math.isclose(out["loss"], float(m["loss"]), rel_tol=1e-5)
        assert math.isclose(out["grad_norm"], float(m["grad_norm"]),
                            rel_tol=1e-4)
        for n, t in model.state_dict().items():
            if n.endswith(("conv0.bias", "conv1.bias", "proj.bias",
                           "bn_extra.bias")):
                tol = dict(rtol=0, atol=2 * v["lr"])    # moved by noise only
            elif n.endswith(".mean"):
                tol = dict(rtol=0, atol=0.02 * v["lr"])
            else:
                tol = dict(rtol=1e-4, atol=1e-5)
            torch.testing.assert_close(out["state"][n], t, msg=n, **tol)


def test_bf16_cast_covers_the_lstm_tensors_and_trains():
    v = values(dtype="bfloat16")
    model, w, cfg = model_and_weights(v)
    lstm = model.listener.layers[0].birnn
    seen = {}
    real = las.L.birnn_apply

    def probe(rnn, xs):
        seen.setdefault("dtypes", set()).update(
            t.dtype for t in list(rnn.parameters()) + list(rnn.buffers()))
        return real(rnn, xs)

    las.L.birnn_apply = probe
    try:
        with las.compute_cast(cfg, model):
            assert lstm.bias_hh_l0.dtype == torch.bfloat16
            assert all(p.dtype == torch.bfloat16 for p in lstm.parameters())
        ts = trainer.TrainState(model.train(),
                                trainer.make_optimizer(model, cfg), 0,
                                torch.Generator().manual_seed(0))
        metrics = trainer.train_step(ts, train_batches(v, 1)[0], cfg)
    finally:
        las.L.birnn_apply = real
    assert seen["dtypes"] == {torch.bfloat16}
    assert math.isfinite(float(metrics["loss"]))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert lstm.bias_hh_l0.dtype == torch.float32


def test_int8_decoder_quantizes_the_gate_cells():
    """The quantized model's greedy logits are those of a float model whose
    cells hold the dequantized weights."""
    v = values(vocab_size=20)
    model, _, cfg = model_and_weights(v)
    feats, featlen, _ = inputs(v, T=40)
    q = quant.maybe_quantize(model, cfg.replace(quantize_decoder="int8"))
    deq = quant.maybe_quantize(model, cfg)
    for cell, qc in zip(deq.speller.cells, q.speller.cells):
        assert isinstance(qc, quant.QuantLinear)
        assert qc.q.shape == (4 * v["dec_units"], cell.in_features)
        with torch.no_grad():
            cell.weight.copy_(qc.q.float() * qc.w_scale[:, None])
    with torch.no_grad():
        got, _, _ = q(feats, featlen, 6)
        want, _, _ = deq(feats, featlen, 6)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_the_jax_conversions_refuse_lstm():
    v = values()
    model, _, cfg = model_and_weights(v)
    for call in (lambda: convert.to_jax_params(model),
                 lambda: convert.from_jax_params({}, {}, cfg, CPU),
                 lambda: convert.per_parameter(model, {}, "opt/adam/mu")):
        with pytest.raises(ValueError, match="no LSTM LAS"):
            call()


@pytest.mark.parametrize("enc_type", ["cnn", "pblstm"])
def test_rnn_cell_rnn_keeps_every_state_dict_key_and_shape(enc_type):
    v = values(rnn_cell="rnn", enc_type=enc_type, apply_bn=True, ctc=True)
    model = las.LAS(harness.program_config(v))
    want = {n: s for n, s, _ in tanh_ref.param_spec(v)}
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == want


def test_cell_flag_init_and_refusal():
    assert parse_args([]).rnn_cell == "rnn"
    assert parse_args(["--rnn_cell", "lstm"]).rnn_cell == "lstm"
    with pytest.raises(ValueError, match="--rnn_cell"):
        las.LAS(Config(rnn_cell="gru"))
    cfg = harness.program_config(values(apply_bn=True))
    model = las.init(cfg, torch.Generator().manual_seed(0), CPU)
    lstm = model.listener.layers[1].birnn
    U = cfg.enc_units
    assert isinstance(lstm, torch.nn.LSTM)
    assert [n for n, _ in lstm.named_buffers()] == ["bias_hh_l0",
                                                    "bias_hh_l0_reverse"]
    limit = math.sqrt(6.0 / (U + U + 4 * U))
    w = lstm.weight_hh_l0
    assert w.abs().max() <= limit and w.abs().max() > 0.9 * limit
    assert not lstm.bias_ih_l0.any() and not lstm.bias_hh_l0.any()
    cell = model.speller.cells[0]
    d = cell.in_features
    assert cell.out_features == 4 * cfg.dec_units
    limit = math.sqrt(6.0 / (d + 4 * cfg.dec_units))
    assert cell.weight.abs().max() <= limit and not cell.bias.any()


def test_train_cli_trains_an_lstm_las(tmp_path):
    d = str(tmp_path)
    cli_shards(d, np.random.default_rng(0))
    ts, hist = train_cli.main(cli_args(d) + [
        "--rnn_cell", "lstm", "--ctc", "False", "--epoch", "1",
        "--steps_per_epoch", "2"])
    assert ts.step == 2 and np.all(np.isfinite(hist["loss"]))
    assert isinstance(ts.model.listener.layers[0].birnn, torch.nn.LSTM)
    assert os.path.exists(os.path.join(d, "model", "config.json"))

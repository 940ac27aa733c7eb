"""The port's training path (automatic_speech_recognition_torch/ops/layers.py
training branches, models/las.py training branch and losses,
training/trainer.py) against the JAX package on the same NumPy inputs and
JAX params, carried over by models/convert.from_jax_params and read back by
convert.to_jax_params.

Tolerances, float32 on both sides with sums in another order:
- layers, losses and schedules: rtol 1e-5 (atol 1e-5 where values cross 0);
- the optimizer fed identical gradients: rtol 1e-6 / atol 1e-6.  optax
  takes Adam's bias correction 1 - 0.999^t in float32 (about 3e-5
  relative error at t = 1), torch.optim.Adam in float64, so an update of
  lr = 1e-2 differs by up to about 2e-7;
- train steps: loss and gradient global norm rtol 1e-4; parameters and BN
  statistics rtol 1e-4 / atol 1e-5, except the listener's projection
  biases.  Those feed a training-mode BN, which subtracts the batch mean,
  so their exact gradient is 0 and both frameworks compute rounding noise
  of about 1e-9, which Adam divides by its own size: each step moves them
  by up to lr in a random direction.  They are held to atol 2 * steps * lr,
  and the BN moving means, which take 0.01 of that shift per step, to
  atol 0.02 * steps * lr.
The stochastic paths (dropout, variational noise, the scheduled-sampling
coin) draw from a torch.Generator, not from JAX keys, so they are checked
by their statistics with fixed seeds.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from automatic_speech_recognition_tpu.models import las as jlas
from automatic_speech_recognition_tpu.ops import layers as JL
from automatic_speech_recognition_tpu.training import trainer as jtrainer
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.models import las as tlas
from automatic_speech_recognition_torch.ops import layers as TL
from automatic_speech_recognition_torch.training import trainer as ttrainer

from test_torch_las import jax_cfg, jax_model, small_cfg

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def make_batch(rng, B=3, T=41, L=7):
    """Features, ragged lengths, and labels with an <EOS> and PAD tails."""
    x = rng.standard_normal((B, T, 13, 3)).astype(np.float32)
    xl = np.array([T, 30, 20][:B], np.int32)
    y = rng.integers(3, 29, (B, L)).astype(np.int32)
    y[1, 5:] = 0
    y[2, 3], y[2, 4:] = 2, 0
    return x, xl, y, (y != 0).sum(1).astype(np.int32)


def jax_state(cfg, params, state):
    return jtrainer.TrainState(params, state,
                               jtrainer.make_optimizer(jax_cfg(cfg)).init(params),
                               jnp.zeros((), jnp.int32),
                               jax.random.PRNGKey(0))


def port_state(cfg, params, state):
    model = convert.from_jax_params(params, state, cfg, CPU).train()
    return ttrainer.TrainState(model, ttrainer.make_optimizer(model, cfg), 0,
                               torch.Generator().manual_seed(0))


def _leaves(tree):
    return {jax.tree_util.keystr(k): np.asarray(v)
            for k, v in jax.tree_util.tree_leaves_with_path(tree)}


# ---------------------------------------------------------------- layers


@pytest.mark.parametrize("shape", [(2, 5, 6), (2, 5, 4, 6)])
def test_bn_training_matches_jax(rng, shape):
    C = shape[-1]
    params = {"scale": rng.standard_normal(C).astype(np.float32),
              "bias": rng.standard_normal(C).astype(np.float32)}
    state = {"mean": rng.standard_normal(C).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    x[1, 3:] = 0.0                       # padded frames count, unmasked
    want, want_state = JL.bn_apply(params, state, x, is_training=True)
    bn = TL.BatchNorm(C)
    with torch.no_grad():
        for k in ("scale", "bias"):
            getattr(bn, k).copy_(_t(params[k]))
        for k in ("mean", "var"):
            getattr(bn, k).copy_(_t(state[k]))
    got, (mean, var) = bn.normalize(_t(x), is_training=True)
    np.testing.assert_allclose(got.detach().numpy(), want, **TOL)
    np.testing.assert_allclose(mean.numpy(), want_state["mean"], rtol=1e-5)
    np.testing.assert_allclose(var.numpy(), want_state["var"], rtol=1e-5)
    # the module's own statistics are untouched: the caller assigns them
    np.testing.assert_array_equal(bn.mean.numpy(), state["mean"])


def test_dropout_keeps_1_minus_rate_and_rescales():
    x = torch.ones(200_000)
    g = torch.Generator().manual_seed(0)
    y = TL.dropout(x, 0.3, True, g)
    kept = y != 0
    # 200k Bernoulli(0.7) draws: std of the mean ~1e-3
    assert abs(kept.float().mean().item() - 0.7) < 5e-3
    np.testing.assert_allclose(y[kept].numpy(), 1 / 0.7, rtol=1e-6)
    # a no-op at inference, at rate 0 and without a generator
    for args in ((0.3, False, g), (0.0, True, g), (0.3, True, None)):
        assert TL.dropout(x, *args) is x


def test_embedding_variational_noise_has_std_0_075():
    table = torch.zeros(50, 400)
    ids = torch.arange(50)
    assert torch.equal(TL.embedding_lookup(table, ids), table)
    noisy = TL.embedding_lookup(table, ids, torch.Generator().manual_seed(1))
    # 20k N(0, 0.075^2) draws: std estimate within ~1% of 0.075
    assert abs(noisy.std().item() - 0.075) < 2e-3
    assert abs(noisy.mean().item()) < 2e-3


# ------------------------------------------------------------ model pieces


@pytest.mark.parametrize("apply_bn", [False, True])
def test_training_forward_matches_jax(rng, apply_bn):
    """Teacher-forced las_forward: logits, CTC logits, alphas and the new
    BN statistics."""
    cfg = small_cfg(apply_bn=apply_bn, ctc=True)
    params, state = jax_model(cfg, rng)
    x, xl, y, _ = make_batch(rng)
    logits, ctc_logits, alphas, enc_len, new_state = jlas.las_forward(
        params, state, x, xl, jax_cfg(cfg), y.shape[1], teacher=y, is_training=True)
    model = convert.from_jax_params(params, state, cfg, CPU).train()
    with torch.no_grad():
        got = tlas.las_forward(model, _t(x), _t(xl), cfg, y.shape[1],
                               teacher=_t(y), is_training=True)
    for g, w in zip(got[:4], (logits, ctc_logits, alphas, enc_len)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    tlas.assign_bn_state(model, got[4])
    _, bn_state = convert.to_jax_params(model)
    want, have = _leaves(new_state), _leaves(bn_state)
    assert want.keys() == have.keys()
    for k in want:
        np.testing.assert_allclose(have[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("smoothing", [True, False])
def test_attention_loss_matches_jax(rng, smoothing):
    cfg = small_cfg(label_smoothing=smoothing)
    logits = rng.standard_normal((3, 6, 30)).astype(np.float32) * 3
    _, _, y, _ = make_batch(rng, L=8)
    want = jlas.attention_loss(logits, y, jax_cfg(cfg))
    got = tlas.attention_loss(_t(logits), _t(y), cfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)
    # an all-PAD batch: 0, not NaN, on both sides
    pad = np.zeros_like(y)
    assert float(jlas.attention_loss(logits, pad, jax_cfg(cfg))) == 0.0
    assert tlas.attention_loss(_t(logits), _t(pad), cfg).item() == 0.0


@pytest.mark.parametrize("drop_last", [False, True])
def test_ctc_loss_matches_optax(rng, drop_last):
    """Feasible rows match optax at rtol 1e-5; the infeasible row (3 labels
    with a repeat need 4 frames, it has 3) is floored near 1e5 as
    optax.ctc_loss floors it, and its gradient stays finite."""
    cfg = small_cfg(ctc=True, ctc_compat_drop_last=drop_last)
    V = cfg.vocab_size
    B, T = 4, 9
    logits = rng.standard_normal((B, T, V + 1)).astype(np.float32)
    y = np.zeros((B, 6), np.int32)
    y[0, :5] = [5, 6, 6, 7, 2]
    y[1, :3] = [9, 10, 2]
    y[2, :3] = [4, 4, 2]
    y[3, :4] = [8, 8, 9, 2]
    enc_len = np.array([9, 6, 3, 9], np.int32)
    want = float(jlas.ctc_loss(logits, y, enc_len, jax_cfg(cfg)))
    lg = _t(logits).requires_grad_()
    got = tlas.ctc_loss(lg, _t(y), _t(enc_len), cfg)
    got.backward()
    assert torch.isfinite(lg.grad).all()
    # row 2 costs ~1e5 in both, the feasible rows ~10: compare the mean,
    # then the feasible rows alone
    np.testing.assert_allclose(got.item(), want, rtol=1e-4)
    ok = [0, 1, 3]
    want_ok = float(jlas.ctc_loss(logits[ok], y[ok], enc_len[ok], jax_cfg(cfg)))
    got_ok = tlas.ctc_loss(_t(logits[ok]), _t(y[ok]), _t(enc_len[ok]), cfg)
    np.testing.assert_allclose(got_ok.item(), want_ok, rtol=1e-5)


def test_ctc_drop_last_on_an_all_pad_batch_is_a_no_op(rng):
    cfg = small_cfg(ctc=True, ctc_compat_drop_last=True)
    logits = rng.standard_normal((2, 5, 31)).astype(np.float32)
    y = np.zeros((2, 3), np.int32)
    enc_len = np.array([5, 4], np.int32)
    want = float(jlas.ctc_loss(logits, y, enc_len, jax_cfg(cfg)))
    got = tlas.ctc_loss(_t(logits), _t(y), _t(enc_len), cfg).item()
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_learning_rate_schedule_matches_jax():
    cfg = small_cfg(lr=1e-3, lr_decay_start=50, lr_decay_step=100,
                    lr_decay_rate=0.5, lr_min_ratio=0.01)
    for step in (0, 1, 49, 50, 51, 150, 333, 1000, 10_000):
        np.testing.assert_allclose(
            tlas.scheduled_learning_rate(cfg, step).item(),
            float(jlas.scheduled_learning_rate(jax_cfg(cfg), step)), rtol=1e-6)


def test_sampling_rate_schedule_matches_jax():
    cfg = small_cfg(warmup_step=10, max_step=110, min_rate=0.4)
    for step in (0, 10, 11, 60, 109, 110, 500):
        np.testing.assert_allclose(
            tlas.scheduled_sampling_rate(cfg, step).item(),
            float(jlas.scheduled_sampling_rate(jax_cfg(cfg), step)), rtol=1e-6)
    bad = small_cfg(warmup_step=10, max_step=10)
    with pytest.raises(ValueError, match="max_step > warmup_step"):
        jlas.scheduled_sampling_rate(jax_cfg(bad), 0)
    with pytest.raises(ValueError, match="max_step > warmup_step"):
        tlas.scheduled_sampling_rate(bad, 0)


def _coin_model(cfg):
    """A speller whose own distribution always samples token 5: the
    output layer sees only its bias."""
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    with torch.no_grad():
        model.speller.out.weight.zero_()
        model.speller.out.bias.fill_(-50.0)
        model.speller.out.bias[5] = 50.0
    return model


def test_scheduled_sampling_coin_rate(monkeypatch):
    """One batch-level coin per step: the teacher's id (7) is fed with
    probability tf_rate, the sampled id (5) otherwise, for every row at
    once."""
    cfg = small_cfg()
    model = _coin_model(cfg)
    fed = []
    lookup = TL.embedding_lookup

    def spy(table, ids, generator=None, vn_std=0.075):
        fed.append(ids.clone())
        return lookup(table, ids, generator, vn_std)

    monkeypatch.setattr(tlas.L, "embedding_lookup", spy)
    steps, B = 400, 3
    enc = torch.randn(B, 5, 32, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        tlas.speller_train(model.speller, cfg, enc, torch.tensor([5, 4, 3]),
                           torch.full((B, steps), 7),
                           torch.Generator().manual_seed(3),
                           tf_rate=torch.tensor(0.3))
    ids = torch.stack(fed[1:])                   # fed[0] is <SOS>
    assert set(ids.unique().tolist()) == {5, 7}
    assert (ids == ids[:, :1]).all()             # one coin for the batch
    # 400 Bernoulli(0.3) coins: std of the rate ~0.023
    assert abs((ids[:, 0] == 7).float().mean().item() - 0.3) < 0.07


def test_stochastic_training_without_a_generator_raises(rng):
    x, xl, y, _ = make_batch(rng)
    for kw in (dict(dropout_rate=0.1), dict(add_vn=True)):
        cfg = small_cfg(**kw)
        model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
        with pytest.raises(ValueError, match="generator is required"):
            tlas.las_forward(model, _t(x), _t(xl), cfg, y.shape[1],
                             teacher=_t(y), is_training=True)
        # inference needs none
        tlas.las_forward(model, _t(x), _t(xl), cfg, 4, is_training=False)
    cfg = small_cfg()
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    with pytest.raises(ValueError, match="generator is required"):
        tlas.las_forward(model, _t(x), _t(xl), cfg, y.shape[1],
                         teacher=_t(y), is_training=True,
                         tf_rate=torch.tensor(0.9))


# --------------------------------------------------------------- optimizer


@pytest.mark.parametrize("accum", [1, 2])
def test_optimizer_matches_optax_on_identical_gradients(rng, accum):
    """Clip (one step under, the rest over the clip norm), Adam and the
    decayed LR, and MultiSteps' running mean with accum 2."""
    cfg = small_cfg(lr=1e-2, grad_clip=5.0, grad_accum_steps=accum,
                    lr_decay_start=2, lr_decay_step=2, lr_decay_rate=0.5,
                    lr_min_ratio=0.01)
    shapes = [(4, 3), (5,), (2, 2, 3)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    tx = jtrainer.make_optimizer(jax_cfg(cfg))
    jp = [jnp.asarray(p) for p in params]
    st = tx.init(jp)
    tp = [torch.nn.Parameter(_t(p.copy())) for p in params]
    opt = ttrainer.Optimizer(tp, cfg)
    for k in range(8):
        scale = 0.1 if k == 0 else 10.0
        grads = [(rng.standard_normal(s) * scale).astype(np.float32)
                 for s in shapes]
        up, st = tx.update([jnp.asarray(g) for g in grads], st, jp)
        jp = optax.apply_updates(jp, up)
        opt.update([_t(g) for g in grads])
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-6, atol=1e-6)
    assert opt.count == 8 // accum


# -------------------------------------------------------------- train step


def _assert_params_match(ts, jts, cfg, steps):
    have = _leaves(convert.to_jax_params(ts.model))
    want = _leaves((jts.params, jts.bn_state))
    assert have.keys() == want.keys()
    for k in want:
        if "['proj']['b']" in k:
            tol = dict(rtol=0, atol=2 * steps * cfg.lr)
        elif "['bn_main']['mean']" in k:
            tol = dict(rtol=0, atol=0.02 * steps * cfg.lr)
        else:
            tol = dict(rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(have[k], want[k], err_msg=k, **tol)


@pytest.mark.parametrize("ctc", [False, True])
@pytest.mark.parametrize("steps", [1, 3])
def test_train_step_matches_jax(rng, steps, ctc):
    """Teacher forcing, dropout 0, no VN: loss and grad norm of every step,
    then the parameters and BN statistics."""
    cfg = small_cfg(ctc=ctc)
    params, state = jax_model(cfg, rng)
    batch = make_batch(rng)
    jts = jax_state(cfg, params, state)
    ts = port_state(cfg, params, state)
    tb = tuple(map(_t, batch))
    for _ in range(steps):
        jts, jm = jtrainer.train_step(jts, batch, jax_cfg(cfg), dec_steps=7)
        m = ttrainer.train_step(ts, tb, cfg)
        for k in ("loss", "grad_norm", "lr", "tf_rate", "att_peak"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-4,
                                       err_msg=k)
    assert ts.step == int(jts.step) == steps
    _assert_params_match(ts, jts, cfg, steps)


def test_grad_accumulation_matches_jax(rng):
    """grad_accum_steps 2 over 4 micro-steps: the parameters move on the
    2nd and 4th only, and agree with optax.MultiSteps."""
    cfg = small_cfg(grad_accum_steps=2)
    params, state = jax_model(cfg, rng)
    batches = [make_batch(rng) for _ in range(4)]
    jts = jax_state(cfg, params, state)
    ts = port_state(cfg, params, state)
    w0 = ts.model.speller.out.weight.detach().clone()
    for i, batch in enumerate(batches):
        jts, jm = jtrainer.train_step(jts, batch, jax_cfg(cfg), dec_steps=7)
        m = ttrainer.train_step(ts, tuple(map(_t, batch)), cfg)
        np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                                   rtol=1e-4)
        moved = not torch.equal(ts.model.speller.out.weight, w0)
        assert moved == (i >= 1), i
    _assert_params_match(ts, jts, cfg, 2)


def test_remat_gives_the_same_gradients(rng):
    x, xl, y, yl = make_batch(rng)
    grads = []
    for remat in (False, True):
        cfg = small_cfg(remat=remat)
        model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU).train()
        loss, _ = tlas.total_loss(model, tuple(map(_t, (x, xl, y, yl))),
                                  cfg, y.shape[1], None, 0)
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_bias_hh_stays_zero_and_the_parameters_are_jax_s(rng):
    """nn.RNN's bias_hh is a buffer: out of the optimizer, exactly zero
    after training, and the trainable count is the JAX pytree's."""
    cfg = small_cfg(lr=1e-2)
    ts = ttrainer.create_train_state(cfg, CPU)
    params, _ = jlas.las_init(jax.random.PRNGKey(0), jax_cfg(cfg))
    assert tlas.num_params(ts.model) == jlas.num_params(params)
    assert sum(p.numel() for p in ts.optimizer.params) == \
        jlas.num_params(params)
    batch = tuple(map(_t, make_batch(rng)))
    for _ in range(3):
        ttrainer.train_step(ts, batch, cfg)
    for layer in ts.model.listener.layers:
        for name in ("bias_hh_l0", "bias_hh_l0_reverse"):
            b = getattr(layer.birnn, name)
            assert not b.requires_grad and torch.equal(b, torch.zeros_like(b))
        assert not layer.birnn.bias_ih_l0.eq(0).all()   # the real bias moved


def test_overfit_tiny_batch():
    """Fixed batch, repeated steps: loss must collapse (the JAX package's
    learnability gate, tests/test_train_eval.py)."""
    from automatic_speech_recognition_torch.config import Config
    from test_train_eval import TINY
    from test_train_eval import make_batch as tiny_batch
    cfg = Config(**TINY)
    batch = tuple(map(_t, tiny_batch(np.random.default_rng(0))))
    ts = ttrainer.create_train_state(cfg, CPU)
    losses = [ttrainer.train_step(ts, batch, cfg)["loss"].item()
              for _ in range(60)]
    assert losses[-1] < 0.3 * losses[0], losses[::10]
    assert losses[-1] < 1.0, losses[-1]
    m = ttrainer.train_step(ts, batch, cfg)
    assert 0.0 <= m["att_peak"].item() <= 1.0 + 1e-6
    assert m["sample_ids"].shape == (8,)


def test_unported_training_paths_raise(rng):
    """make_mesh_train_step over a one-device mesh is train_step itself
    (same metrics, same state); tensor parallelism and a mesh of several
    devices in one process are refused, and so is train_multi_step."""
    from automatic_speech_recognition_torch.parallel.mesh import make_mesh
    cfg = small_cfg()
    batch = make_batch(rng)
    ts = ttrainer.create_train_state(cfg, CPU)
    ref = ttrainer.create_train_state(cfg, CPU)
    step_fn, ts, shard = ttrainer.make_mesh_train_step(
        make_mesh(devices=[CPU]), ts, batch, cfg)
    got = step_fn(ts, shard(batch))
    want = ttrainer.train_step(ref, tuple(map(_t, batch)), cfg)
    assert got["loss"].item() == want["loss"].item()
    assert got["grad_norm"].item() == want["grad_norm"].item()
    for a, b in zip(ts.model.state_dict().values(),
                    ref.model.state_dict().values()):
        assert torch.equal(a, b)
    # a model axis of 2 needs two positions: one device cannot hold it
    with pytest.raises(ValueError, match="1 devices not divisible by 2"):
        make_mesh(devices=[CPU], num_partitions=2)
    with pytest.raises(ValueError, match="torchrun"):
        ttrainer.make_mesh_train_step(make_mesh(devices=[CPU, CPU]), ts,
                                      batch, cfg)
    with pytest.raises(NotImplementedError, match="Not ported"):
        ttrainer.train_multi_step(ts, None, cfg, 4)


# ------------------------------------------- the speller's CUDA graphs


def _split_speller(model):
    from automatic_speech_recognition_torch.parallel import \
        tensor_parallel as tp
    tp.shard_(model, {"speller.attention.w_s.weight": 0},
              tp.DeviceAxis([CPU, CPU]))


@pytest.mark.parametrize("device,change,tf_rate,eligible", [
    ("cuda", {}, 1.0, True),
    ("cpu", {}, 1.0, False),
    ("cuda", {"dropout_rate": 0.1}, 1.0, False),
    ("cuda", {"add_vn": True}, 1.0, False),
    ("cuda", {}, 0.9, False),
    ("cuda", {}, torch.tensor(1.0), False),
    ("cuda", {"remat": True}, 1.0, False),
    ("cuda", {"split": True}, 1.0, False),
    ("cuda", {"no_grad": True}, 1.0, False),
    ("cuda", {"enc_out_no_grad": True}, 1.0, False),
    ("cuda", {"frozen_weight": True}, 1.0, False),
    ("cuda", {"capturing": True}, 1.0, False),
])
def test_graph_eligibility(monkeypatch, device, change, tf_rate, eligible):
    """The graph pair engages on a CUDA device under pure teacher forcing
    (a float tf_rate >= 1) with nothing drawn in the loop, no remat, no
    split speller, where autograd records the loop (grad mode, enc_out and
    every weight requiring a gradient) and outside another capture; every
    other case takes the eager loop.  (A stand-in for enc_out needs no
    card: the rule reads its device and requires_grad.)"""
    import types
    change = dict(change)
    flags = {k: change.pop(k, False) for k in (
        "split", "no_grad", "enc_out_no_grad", "frozen_weight", "capturing")}
    cfg = small_cfg(**change)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    if flags["split"]:
        _split_speller(model)
    if flags["frozen_weight"]:
        model.speller.attention.w_s.weight.requires_grad_(False)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing",
                        lambda: flags["capturing"])
    enc_out = types.SimpleNamespace(device=torch.device(device),
                                    requires_grad=not flags["enc_out_no_grad"])
    with torch.set_grad_enabled(not flags["no_grad"]):
        got = tlas.graph_eligible(model.speller, cfg, tf_rate, enc_out)
    assert got is eligible


@pytest.mark.parametrize("change", [{}, {"dropout_rate": 0.1},
                                    {"add_vn": True},
                                    {"scheduled_sampling": True},
                                    {"remat": True}, {"split": True}])
def test_eager_loop_counts_every_step_and_no_graph_step(rng, change):
    """On the CPU, and with dropout, variational noise, scheduled sampling,
    remat or a split speller, train steps run the eager loop:
    `las.speller.steps` counts every decoder step, no replay or capture is
    counted, and the speller's graph cache stays empty."""
    from automatic_speech_recognition_torch.utils import spans
    change = dict(change)
    split = change.pop("split", False)
    cfg = small_cfg(warmup_step=0, max_step=4, min_rate=0.5, **change)
    ts = ttrainer.create_train_state(cfg, CPU)
    if split:
        _split_speller(ts.model)
    batch = tuple(map(_t, make_batch(rng)))
    before = spans.totals()
    for _ in range(3):
        ttrainer.train_step(ts, batch, cfg)
    got = spans.report(before, ("las.speller.",))
    assert got["las.speller.steps"] == {"count": 3 * batch[2].shape[1]}
    assert "las.speller.graph_steps" not in got
    assert "las.speller.graph_captures" not in got
    assert not tlas.speller_graphs(ts.model.speller).pairs


def test_graph_key_and_the_cache_lifetime(rng):
    """A pair is keyed by (rows, T_enc, decoder steps, dtype, device), not
    by values; the cache lives as long as its speller: freeing the model
    frees it (and with it the graphs and their memory pools)."""
    import gc
    import weakref
    enc = torch.zeros(3, 11, 32)
    ids = torch.zeros(3, 7, dtype=torch.int32)
    key = tlas.graph_key(enc, ids)
    assert key == (3, 11, 7, torch.float32, CPU)
    assert tlas.graph_key(torch.randn(3, 11, 32), ids + 5) == key
    assert len({key, tlas.graph_key(enc[:2], ids[:2]),
                tlas.graph_key(enc[:, :10], ids),
                tlas.graph_key(enc, ids[:, :6]),
                tlas.graph_key(enc.bfloat16(), ids)}) == 5
    model = tlas.init(small_cfg(), torch.Generator().manual_seed(0), CPU)
    cache = tlas.speller_graphs(model.speller)
    assert tlas.speller_graphs(model.speller) is cache
    cache.pairs[key] = torch.empty(1 << 20)
    kept = weakref.ref(cache.pairs[key])
    held = len(tlas._GRAPHS)
    del model, cache
    gc.collect()
    assert len(tlas._GRAPHS) == held - 1 and kept() is None


class _EagerGraphs:
    """SpellerGraphs' interface on the CPU: a "replay" runs the eager loop
    on detached copies of the inputs, as the graphs read theirs."""

    def __init__(self, sp, cfg, enc_out, enc_len, teacher, weights, cache):
        self.sp, self.cfg = sp, cfg
        self.slots = tlas._loop_slots(sp)

    def forward(self, enc_out, enc_len, teacher, weights):
        self.inputs = [t.detach().requires_grad_()
                       for t in (enc_out, *weights)]
        with torch.enable_grad(), tlas._tensors_in(self.slots,
                                                   self.inputs[1:]):
            self.out = tlas._teacher_loop(self.sp, self.cfg, self.inputs[0],
                                          enc_len, teacher)
        return tuple(o.detach().clone() for o in self.out)

    def backward(self, grad_logits, grad_alphas):
        grads = [torch.zeros_like(o) if g is None else g
                 for o, g in zip(self.out, (grad_logits, grad_alphas))]
        return torch.autograd.grad(self.out, self.inputs, grads,
                                   allow_unused=True)


def test_second_sight_capture_and_the_graphed_node(rng, monkeypatch):
    """graphed_loop with a stand-in for the graph pair on the CPU: the
    first two calls of a shape run eager, the third captures (one
    capture) and replays, later ones replay; the autograd node gives the
    eager
    loop's logits, alphas and gradients (enc_out and every speller
    weight) bit for bit; a second shape gets its own pair; and a backward
    whose activations a later replay of either shape overwrote raises."""
    from automatic_speech_recognition_torch.utils import spans
    cfg = small_cfg(mode="add")
    monkeypatch.setattr(tlas, "SpellerGraphs", _EagerGraphs)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU).train()
    sp = model.speller
    weights = [p for n, p in sp.named_parameters()
               if not n.startswith("ctc_head")]

    def step(B, T, L, graphed, seed):
        g = torch.Generator().manual_seed(seed)
        enc = torch.randn(B, T, tlas.enc_out_dim(cfg), generator=g,
                          requires_grad=True)
        enc_len = torch.tensor([T] * (B - 1) + [T - 3], dtype=torch.int32)
        ids = torch.randint(3, cfg.vocab_size, (B, L), generator=g,
                            dtype=torch.int32)
        fn = tlas.graphed_loop if graphed else tlas._teacher_loop
        logits, alphas = fn(sp, cfg, enc, enc_len, ids)
        loss = (logits.square().mean() + alphas.mean()
                if B == 3 else logits.logsumexp(-1).mean())
        return [logits, alphas, *torch.autograd.grad(loss, [enc, *weights])]

    before = spans.totals()
    for i, shape in enumerate([(3, 9, 5)] * 4 + [(2, 6, 4)] * 3):
        for a, b in zip(step(*shape, True, i), step(*shape, False, i)):
            assert torch.equal(a, b), (i, shape)
    got = spans.report(before, ("las.speller.",))
    assert got["las.speller.graph_captures"] == {"count": 2}
    assert got["las.speller.graph_steps"] == {"count": 2 * 5 + 1 * 4}
    pairs = tlas.speller_graphs(sp).pairs
    assert sorted(k[:3] for k in pairs) == [(2, 6, 4), (3, 9, 5)]
    assert all(isinstance(v, _EagerGraphs) for v in pairs.values())
    enc = torch.randn(2, 6, tlas.enc_out_dim(cfg), requires_grad=True)
    args = (torch.tensor([6, 6]), torch.ones(2, 4, dtype=torch.int32))
    first, _ = tlas.graphed_loop(sp, cfg, enc, *args)
    # another shape's forward shares the pool: it overwrites as well
    tlas.graphed_loop(sp, cfg, torch.randn(3, 9, enc.shape[2],
                                           requires_grad=True),
                      torch.tensor([9, 9, 9]),
                      torch.ones(3, 5, dtype=torch.int32))
    with pytest.raises(RuntimeError, match="later replay"):
        first.sum().backward()
    tlas._GRAPHS.pop(sp)

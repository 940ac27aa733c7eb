"""Tensor parallelism on the port (automatic_speech_recognition_torch/
parallel/tensor_parallel.py, sharding.py's layout, the (data, model) grid
of parallel/mesh.py and distributed.py), mirroring tests/test_sharding.py:
gloo processes on the CPU, each given torchrun's environment by hand as
tests/test_torch_distributed.py does, and evaluation over a device list
in this process.

- The split decision equals the JAX package's param_spec on every leaf at
  tp 2 and 4, on the tiny model and at published width, and a rank holds
  the element counts that layout gives.
- The three autograd Functions against a whole Linear: output, input
  gradient and weight gradient.
- The train step at tp 2 (world 2) and at dp 2 x tp 2 and dp 1 x tp 4
  (world 4), with BN and CTC on, against the one-process port step and
  the JAX package's make_mesh_train_step on the 8 virtual CPU devices at
  num_partitions 2 (the same parameters, models/convert): loss and
  gradient norm within rtol 1e-4, the parameters by
  tests/test_torch_distributed.py's form of tests/test_torch_train.py's
  rule.  Also bf16 (rtol 2e-3: a bias added after the gather rounds in
  bf16 once more than the fused product's), grad_accum_steps 2 and a
  stochastic step, which at dp 1 draws what one process draws.
- Two mutated copies miss that tolerance: one without the backward
  all-reduce of copy_to_model, one that syncs the state over the world
  where the data group belongs.
- Checkpoints are whole: tp 2 -> 1, 1 -> 2, 2 -> 4, and an
  exporter-format import (tools/export_jax_checkpoint.py,
  import_checkpoint) restored at tp 2 and stepped against JAX.
- The train CLI on two ranks at --num_partitions 2 against one process.
- Greedy, beam (LM fusion, joint CTC) and int8 over `cpu,cpu` (and four
  positions) at num_partitions 2 and 4 against one device, through the
  eval pool (parallel/workers.py: one replica inline, two in worker
  processes): tokens equal, logits within 1e-5; the test and decode CLIs
  and the Recognizer so.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import json
import os

import jax
import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.models import las as jlas
from automatic_speech_recognition_tpu.parallel import sharding as jsh
from automatic_speech_recognition_tpu.parallel.mesh import \
    make_mesh as jmake_mesh
from automatic_speech_recognition_tpu.training import trainer as jtrainer
from automatic_speech_recognition_torch import decode as decode_cli
from automatic_speech_recognition_torch import test as test_cli
from automatic_speech_recognition_torch import train as train_cli
from automatic_speech_recognition_torch import transcribe as transcribe_cli
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.decoding import beam as tbeam
from automatic_speech_recognition_torch.models import char_rnn as tcr
from automatic_speech_recognition_torch.models import convert
from automatic_speech_recognition_torch.models import las as tlas
from automatic_speech_recognition_torch.ops import quant
from automatic_speech_recognition_torch.parallel import sharding, workers
from automatic_speech_recognition_torch.parallel import tensor_parallel as tp
from automatic_speech_recognition_torch.parallel.mesh import make_mesh
from automatic_speech_recognition_torch.training import trainer as ttrainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder

from test_torch_decode_cli import MODEL_FLAGS, _wavs, assets  # noqa: F401
from test_torch_distributed import (_CLI, _assert_trees_close, _cli_argv,
                                    _finish, _global_batches, _hist,
                                    _one_process, _retrying,
                                    _sigterm_to_rank_1, _spawn,
                                    _THREE_STEPS, _tree, cli_dir)  # noqa: F401
from test_torch_import_checkpoint import round_trip
from test_torch_las import jax_cfg, jax_model, small_cfg
from test_torch_train import jax_state, port_state
from test_torch_train_cli import _args as cli_args

CPU = torch.device("cpu")
RTOL = 1e-4
BF16_RTOL = 2e-3

# the published char config (chip_smoke.py's published_cfg) and the
# recipe's bpe shape: total parameters and, per rank at tp 2 / tp 4, the
# elements the JAX package's param_spec layout leaves a rank
PUBLISHED = dict(unit="char", vocab_size=30, feat_dim=13, enc_type="cnn",
                 num_enc_channels=32, enc_units=512, num_enc_layers=4,
                 mode="loc", attention_size=128, loc_kernel_size=201,
                 loc_num_channels=10, dec_units=1024, num_dec_layers=2,
                 embedding_size=256)
SHAPES = {"tiny": (small_cfg(ctc=True), None),
          "published_char": (Config(**PUBLISHED),
                             (10_222_370, 5_117_445, 2_589_530)),
          "bpe_ctc": (Config(**dict(PUBLISHED, vocab_size=5003, ctc=True)),
                      (19_159_835, 12_152_702, 8_650_643))}

_WORKER = r"""
import copy
import sys
import torch
import torch.nn.functional as F
from automatic_speech_recognition_torch.parallel import (distributed,
                                                         sharding)
from automatic_speech_recognition_torch.parallel import tensor_parallel as tp
from automatic_speech_recognition_torch.parallel.mesh import (eval_mesh,
                                                              make_mesh)
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)

inputs, out_path = sys.argv[1:3]
assert distributed.maybe_initialize("cpu") is True
rank, world = distributed.process_index(), distributed.process_count()
cpu = torch.device("cpu")
data = torch.load(inputs, weights_only=False)
meshes, out = {}, {"rank": rank}


def mesh_of(k):
    if k not in meshes:
        meshes[k] = make_mesh(devices=[cpu], group=distributed.world_group(),
                              num_partitions=k)
    return meshes[k]


def rows(mesh, batch):
    per = batch[0].shape[0] // mesh.shape["data"]
    return tuple(x[mesh.data_index * per:(mesh.data_index + 1) * per]
                 for x in batch)


def whole_adam(ts):
    return sharding.whole_optimizer_state(ts.model,
                                          ts.optimizer.state_dict())


def run(name, k, cfg, batches, restore=None, after=None):
    mesh = mesh_of(k)
    ts = trainer.create_train_state(cfg, cpu, mesh.data_index,
                                    mesh.shape["data"])
    if restore is None:
        ts.model.load_state_dict(data["state"])
    else:
        assert CheckpointManager(restore[0]).restore(ts, restore[1]) is ts
    step_fn, ts, shard = trainer.make_mesh_train_step(mesh, ts, None, cfg)
    res = {"shape": mesh.shape}
    if restore is not None:         # copies: the step updates in place
        res["restored"] = copy.deepcopy(sharding.whole_state_dict(ts.model))
        res["restored_adam"] = copy.deepcopy(whole_adam(ts))
    if after is not None:
        after(ts)
    ms = [step_fn(ts, shard(rows(mesh, b))) for b in batches]
    res.update({key: [m[key].item() for m in ms]
                for key in ("loss", "grad_norm", "att_peak")})
    res["state"] = sharding.whole_state_dict(ts.model)
    res["adam"] = whole_adam(ts)
    res["local"] = {n: tuple(p.shape) for n, p in ts.model.named_parameters()}
    out[name] = res
    return ts


for job in data["jobs"]:
    name, k, over, idx = job["name"], job["k"], job["cfg"], job["batches"]
    cfg = data["cfg"].replace(**over)
    batches = [data["batches"][i] for i in idx]
    mutation = job.get("mutation")
    after = None
    saved = tp._CopyToModel.backward
    if mutation == "no_allreduce":
        tp._CopyToModel.backward = staticmethod(lambda ctx, g: (g, None))
    elif mutation == "world_broadcast":
        after = lambda ts: trainer.sync_state(ts, torch.distributed.group.WORLD)
    elif mutation == "drift" and rank == 1:
        # a replicated parameter's gradient other on rank 1 than on rank 0
        # (as a nondeterministic cuDNN weight gradient can leave it in the
        # last bits; here negated, so the mean is 0 and Adam, whose first
        # step moves by lr whatever the size, shows the difference)
        after = lambda ts: ts.model.speller.attention.u.register_hook(
            lambda g: -g)
    try:
        ts = run(name, k, cfg, batches, job.get("restore"), after)
    finally:
        tp._CopyToModel.backward = saved
    if "save" in job:
        CheckpointManager(job["save"]).save(1, ts)

if world == 2:
    # the three Functions against a whole Linear of 6 -> 8
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 6, generator=g)
    b = torch.randn(8, generator=g)
    x = torch.randn(3, 6, generator=g)
    up = torch.randn(3, 8, generator=g)
    group = mesh_of(2).model_group
    half = slice(rank * 4, rank * 4 + 4)
    xs = x.clone().requires_grad_()
    ws = w[half].clone().requires_grad_()
    bs = b.clone().requires_grad_()
    y = tp.gather_from_model(F.linear(tp.copy_to_model(xs, group), ws), -1,
                             group) + bs
    (y * up).sum().backward()
    wg = w[half].clone().requires_grad_()
    yw = F.linear(x, tp.gathered_weight(wg, 0, group))
    (yw * up).sum().backward()
    out["functions"] = {"y": y.detach(), "x_grad": xs.grad,
                        "w_grad": ws.grad, "b_grad": bs.grad,
                        "yw": yw.detach(), "gw_grad": wg.grad}
    out["eval_mesh"] = eval_mesh("cpu", 2).shape

torch.save(out, out_path)
distributed.barrier("done")
distributed.destroy()
print("WORKEROK", rank)
"""


def _jobs_world2(d):
    random = dict(dropout_rate=0.3, add_vn=True, scheduled_sampling=True,
                  warmup_step=0, max_step=4, min_rate=0.5, spec_augment=True)
    return [
        dict(name="f32", k=2, cfg={}, batches=[0], save=f"{d}/tp2"),
        dict(name="bf16", k=2, cfg=dict(dtype="bfloat16"), batches=[0]),
        dict(name="accum", k=2, cfg=dict(grad_accum_steps=2),
             batches=[0, 1]),
        dict(name="random", k=2, cfg=random, batches=[0, 1]),
        dict(name="no_allreduce", k=2, cfg={}, batches=[0],
             mutation="no_allreduce"),
        dict(name="world_broadcast", k=2, cfg={}, batches=[0],
             mutation="world_broadcast"),
        dict(name="drift", k=2, cfg={}, batches=[0], mutation="drift"),
        dict(name="from_tp1", k=2, cfg={}, batches=[1],
             restore=(f"{d}/tp1", 1)),
        dict(name="import", k=2, cfg={}, batches=[2],
             restore=(f"{d}/imported", 2)),
    ]


def _jobs_world4(d):
    return [
        dict(name="dp2tp2", k=2, cfg={}, batches=[0], save=f"{d}/dp2tp2"),
        dict(name="dp2tp2_accum", k=2, cfg=dict(grad_accum_steps=2),
             batches=[0, 1]),
        dict(name="tp4", k=4, cfg={}, batches=[0]),
        dict(name="tp4_from_tp2", k=4, cfg={}, batches=[1],
             restore=(f"{d}/tp2", 1)),
    ]


def _run_world(d, world, jobs, cfg, state, batches):
    def run(attempt):
        inp = os.path.join(d, f"in{world}_{attempt}.pt")
        torch.save({"cfg": cfg, "state": state, "jobs": jobs,
                    "batches": [tuple(map(torch.from_numpy, b))
                                for b in batches]}, inp)
        outs = _finish(_spawn(_WORKER, lambda r: [
            inp, os.path.join(d, f"out{world}_{attempt}_{r}.pt")], world))
        for rank, out in enumerate(outs):
            assert f"WORKEROK {rank}" in out, out[-4000:]
        return [torch.load(os.path.join(d, f"out{world}_{attempt}_{r}.pt"),
                           weights_only=False) for r in range(world)]
    return _retrying(run)


@pytest.fixture(scope="session")
def setup(tmp_path_factory):
    """The model (BN and CTC on), three global batches of 4 rows, a
    one-process checkpoint after the first step, and the exporter-format
    round trip of three JAX steps."""
    d = str(tmp_path_factory.mktemp("tp"))
    rng = np.random.default_rng(0)
    cfg = small_cfg(apply_bn=True, ctc=True)
    params, state = jax_model(cfg, rng)
    batches = _global_batches(rng, 2)
    jts, jbatches, _, _, imported = round_trip(
        tmp_path_factory.mktemp("import"), cfg, np.random.default_rng(1))
    os.rename(imported, f"{d}/imported")
    # the import's next batch, 3 rows, padded to the 4-row global batch
    # by a copy of its first row
    batches.append(tuple(np.concatenate([x, x[:1]]) for x in jbatches[3]))
    ts = port_state(cfg, params, state)
    ttrainer.train_step(ts, tuple(map(torch.from_numpy, batches[0])), cfg)
    CheckpointManager(f"{d}/tp1").save(1, ts)
    return dict(d=d, cfg=cfg, params=params, state=state, batches=batches,
                jts=jts, model=convert.from_jax_params(params, state, cfg,
                                                       CPU))


@pytest.fixture(scope="session")
def world2(setup):
    s = setup
    return _run_world(s["d"], 2, _jobs_world2(s["d"]), s["cfg"],
                      s["model"].state_dict(), s["batches"])


@pytest.fixture(scope="session")
def world4(setup, world2):
    s = setup
    return _run_world(s["d"], 4, _jobs_world4(s["d"]), s["cfg"],
                      s["model"].state_dict(), s["batches"])


# ------------------------------------------------------------- the layout


def test_param_spec_rules():
    """tests/test_sharding.py's cases on the port's param_spec."""
    assert sharding.param_spec((8, 16), 2) == 1
    assert sharding.param_spec((8, 2), 2) is None
    assert sharding.param_spec((8, 15), 2) is None
    assert sharding.param_spec((16,), 2) is None
    assert sharding.param_spec((), 2) is None
    assert sharding.param_spec((8, 16), 1) is None
    assert sharding.param_spec((201, 1, 10), 2) == 2
    assert sharding.param_spec((201, 1, 10), 4) is None


def test_make_mesh_shapes():
    """tests/test_sharding.py's mesh shapes, over a device list."""
    mesh = make_mesh(devices=[CPU] * 8, num_partitions=2)
    assert mesh.shape == {"data": 4, "model": 2} and mesh.size == 8
    assert mesh.replica_devices() == [[CPU, CPU]] * 4
    assert make_mesh(devices=[CPU] * 8).shape == {"data": 8, "model": 1}
    with pytest.raises(ValueError, match="not divisible by 3 partitions"):
        make_mesh(devices=[CPU] * 8, num_partitions=3)


def _jax_leaves(cfg):
    """Path -> the JAX package's PartitionSpec at tp 2 and 4, on shapes
    alone (no weights are drawn)."""
    shapes = jax.eval_shape(lambda k: jlas.las_init(k, jax_cfg(cfg)),
                            jax.random.PRNGKey(0))
    leaves = jax.tree_util.tree_map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    out = {}
    for k in (2, 4):
        for prefix, tree in zip(("params", "state"), leaves):
            for path, spec in jax.tree_util.tree_leaves_with_path(
                    jsh.param_specs(tree, k)):
                key = "/".join([prefix] + [p.key for p in path])
                out.setdefault(key, {})[k] = spec
    return out


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_split_decision_equals_jax_param_spec(shape):
    """Leaf by leaf: a leaf JAX splits has every port tensor it fills
    split, along the port axis that is the leaf's last (dim 1 of the
    embedding table, dim 0 elsewhere); a replicated one has none.  At
    published width a rank holds the elements of that layout."""
    cfg, counts = SHAPES[shape]
    with torch.device("meta"):
        model = tlas.LAS(cfg)
    names = {id(t): n for n, t in list(model.named_parameters())
             + list(model.named_buffers())}
    jax_specs = _jax_leaves(cfg)
    targets = convert._targets(model)
    assert set(targets) == set(jax_specs)
    for k in (2, 4):
        dims = sharding.param_specs(model, k)
        for path, fills in targets.items():
            spec = jax_specs[path][k]
            for tensor, _ in fills:
                name = names[id(tensor)]
                if spec == jax.sharding.PartitionSpec():
                    assert name not in dims, (k, path)
                else:
                    assert spec[-1] == "model", (k, path, spec)
                    want = 1 if path.endswith("embedding/table") else 0
                    assert dims.get(name) == want, (k, path)
        if counts is not None:
            per_rank = sum(p.numel() // k if n in dims else p.numel()
                           for n, p in model.named_parameters())
            assert per_rank == counts[k // 2], (k, per_rank)
    if counts is not None:
        assert sum(p.numel() for p in model.parameters()) == counts[0]


def test_published_edges():
    """The edges the rule must keep: at the char vocabulary `out` splits
    at tp 2, not at 4; the location conv (10 channels) likewise; in the
    bpe shape `out` (5003) never splits and the CTC head (5004) does at
    both."""
    with torch.device("meta"):
        char_model = tlas.LAS(Config(**PUBLISHED))
        bpe = tlas.LAS(SHAPES["bpe_ctc"][0])
    char = sharding.param_specs(char_model, 2)
    char4 = sharding.param_specs(char_model, 4)
    assert "speller.out.weight" in char and "speller.out.weight" not in char4
    assert "speller.attention.conv_w" in char
    assert "speller.attention.conv_w" not in char4
    for k in (2, 4):
        dims = sharding.param_specs(bpe, k)
        assert "speller.out.weight" not in dims
        assert dims["speller.ctc_head.weight"] == 0
        assert "speller.ctc_head.bias" not in dims


def test_int8_rows_take_their_scales():
    cfg = small_cfg(quantize_decoder="int8", vocab_size=512)
    model = quant.maybe_quantize(
        tlas.init(cfg, torch.Generator().manual_seed(0), CPU), cfg)
    dims = sharding.param_specs(model, 2)
    for name in ("speller.cells.0", "speller.out"):
        assert dims[f"{name}.q"] == 0 and dims[f"{name}.w_scale"] == 0
    with pytest.raises(ValueError, match="int8"):
        convert.to_jax_params(model)


# --------------------------------------------------------- the Functions


def test_functions_against_a_whole_layer(world2):
    """copy_to_model -> column product -> gather_from_model, and
    gathered_weight: each rank's output is the whole layer's; the input
    and bias gradients are whole, the weight gradient the rank's rows of
    the whole one."""
    g = torch.Generator().manual_seed(0)
    w = torch.randn(8, 6, generator=g).requires_grad_()
    b = torch.randn(8, generator=g).requires_grad_()
    x = torch.randn(3, 6, generator=g).requires_grad_()
    up = torch.randn(3, 8, generator=g)
    y = torch.nn.functional.linear(x, w, b)
    (y * up).sum().backward()
    for out in world2:
        f, half = out["functions"], slice(out["rank"] * 4,
                                          out["rank"] * 4 + 4)
        torch.testing.assert_close(f["y"], y.detach())
        torch.testing.assert_close(f["x_grad"], x.grad)
        torch.testing.assert_close(f["b_grad"], b.grad)
        torch.testing.assert_close(f["w_grad"], w.grad[half])
        torch.testing.assert_close(f["yw"], y.detach() - b.detach())
        torch.testing.assert_close(f["gw_grad"], w.grad[half])
    assert world2[0]["eval_mesh"] == {"data": 1, "model": 1}


# -------------------------------------------------------- the train step


@pytest.fixture(scope="session")
def jax_mesh_step(setup):
    """The JAX package's make_mesh_train_step on the 8 virtual CPU devices
    at num_partitions 2 (a 4 x 2 mesh: one row per data shard)."""
    s = setup
    cfg = s["cfg"]
    jc = jax_cfg(cfg.replace(num_partitions=2))
    mesh = jmake_mesh(num_devices=8, num_partitions=2)
    step_fn, jts, shard = jtrainer.make_mesh_train_step(
        mesh, jax_state(cfg, s["params"], s["state"]), s["batches"][0], jc)
    jts, m = step_fn(jts, shard(s["batches"][0]))
    return jts, {k: float(m[k]) for k in ("loss", "grad_norm", "att_peak")}


def _close(got, want, rtol, what):
    np.testing.assert_allclose(got, want, rtol=rtol, err_msg=what)


@pytest.mark.parametrize("name,world", [("f32", 2), ("dp2tp2", 4),
                                        ("tp4", 4)])
def test_step_matches_one_process_and_jax_mesh_step(setup, world2, world4,
                                                    jax_mesh_step, name,
                                                    world):
    s = setup
    got = (world2 if world == 2 else world4)
    cfg = s["cfg"]
    ts, want = _one_process(cfg, s["params"], s["state"], s["batches"][:1])
    jts, jm = jax_mesh_step
    for out in got:
        for k in ("loss", "grad_norm", "att_peak"):
            _close(out[name][k], want[k], RTOL, f"{name} {k} vs one process")
            _close(out[name][k][0], jm[k], RTOL, f"{name} {k} vs JAX mesh")
        for n, v in out[name]["state"].items():
            assert torch.equal(v, got[0][name]["state"][n]), (name, n)
    _assert_trees_close(_tree(cfg, got[0][name]["state"]),
                        convert.to_jax_params(ts.model), 1, cfg.lr)
    _assert_trees_close(_tree(cfg, got[0][name]["state"]),
                        (jts.params, jts.bn_state), 1, cfg.lr)


def test_ranks_hold_their_rows(world2, world4):
    """At tp 2 a rank holds half of each split weight's rows; the grid is
    (data, model) = divmod(rank, k)."""
    local = world2[1]["f32"]["local"]
    assert local["speller.cells.0.weight"] == (16, 16 + 32 + 32)
    assert local["speller.embedding.weight"] == (30, 8)
    assert local["speller.ctc_head.weight"] == (31, 32)
    assert local["listener.layers.0.birnn.weight_hh_l0"] == (16, 32)
    assert world2[0]["f32"]["shape"] == {"data": 1, "model": 2}
    assert world4[0]["dp2tp2"]["shape"] == {"data": 2, "model": 2}
    assert world4[0]["tp4"]["shape"] == {"data": 1, "model": 4}
    assert world4[3]["tp4"]["local"]["speller.out.weight"] == (30, 32)


def test_bf16_at_tp2(setup, world2):
    s = setup
    c16 = s["cfg"].replace(dtype="bfloat16")
    _, want = _one_process(c16, s["params"], s["state"], s["batches"][:1])
    for k in ("loss", "grad_norm"):
        _close(world2[0]["bf16"][k], want[k], BF16_RTOL, k)
    assert all(v.dtype == torch.float32
               for v in world2[0]["bf16"]["state"].values())


@pytest.mark.parametrize("name,world", [("accum", 2),
                                        ("dp2tp2_accum", 4)])
def test_grad_accumulation(setup, world2, world4, name, world):
    """grad_accum_steps 2: one update after two micro-steps, equal to one
    process.  At dp 1 the gradient norm is each micro-step's, as in one
    process; across data groups it is the applied one (NaN first)."""
    s = setup
    got = (world2 if world == 2 else world4)[0][name]
    c2 = s["cfg"].replace(grad_accum_steps=2)
    ts, want = _one_process(c2, s["params"], s["state"], s["batches"][:2])
    _close(got["loss"], want["loss"], RTOL, "loss")
    if world == 2:
        _close(got["grad_norm"], want["grad_norm"], RTOL, "grad_norm")
    else:
        assert np.isnan(got["grad_norm"][0])
        _close(got["grad_norm"][1], ts.optimizer.applied_norm.item(), RTOL,
               "applied norm")
    _assert_trees_close(_tree(c2, got["state"]),
                        convert.to_jax_params(ts.model), 1, c2.lr)


def test_randomness_at_dp1_is_one_process(setup, world2):
    """Dropout, variational noise, scheduled sampling and SpecAugment at
    tp 2 and dp 1: both ranks draw one process's streams (the table noise
    at the whole table's shape), so two steps equal one process's."""
    s = setup
    rcfg = s["cfg"].replace(dropout_rate=0.3, add_vn=True,
                            scheduled_sampling=True, warmup_step=0,
                            max_step=4, min_rate=0.5, spec_augment=True)
    ts = ttrainer.create_train_state(rcfg, CPU)
    ts.model.load_state_dict(s["model"].state_dict())
    want = [ttrainer.train_step(ts, tuple(map(torch.from_numpy, b)), rcfg)
            for b in s["batches"][:2]]
    for out in world2:
        for k in ("loss", "grad_norm"):
            _close(out["random"][k], [m[k].item() for m in want], RTOL, k)


def test_mutated_copies_miss_the_tolerance(setup, world2):
    """Without copy_to_model's all-reduce the layers upstream of a
    column-parallel product take a partial gradient; a sync over the
    world overwrites rank 1's columns with rank 0's.  Both miss the rtol
    the right step meets (which reads one process's loss and norm bit for
    bit here): the first by 0.59 in the gradient norm (its loss is
    right), the second by 7.0e-3 in the loss and 0.48 in the norm."""
    s = setup
    _, want = _one_process(s["cfg"], s["params"], s["state"],
                           s["batches"][:1])
    rel = {name: {k: abs(world2[1][name][k][0] / want[k][0] - 1)
                  for k in ("loss", "grad_norm")}
           for name in ("f32", "no_allreduce", "world_broadcast")}
    assert max(rel["f32"].values()) < RTOL
    assert rel["no_allreduce"]["grad_norm"] > 10 * RTOL
    assert min(rel["world_broadcast"].values()) > 10 * RTOL


def test_replicated_parameters_stay_equal_across_the_model_group(world2):
    """Rank 1's gradient of the replicated attention vector `u` is rank
    0's negated: the model group averages the gradients of the tensors it
    holds whole, so after the step `u` (unmoved: its mean gradient is 0)
    and every other replicated tensor are equal on both ranks."""
    a, b = world2[0]["drift"]["state"], world2[1]["drift"]["state"]
    for n in a:
        assert torch.equal(a[n], b[n]), n
    assert not torch.equal(a["speller.attention.u"],
                           world2[0]["f32"]["state"]["speller.attention.u"])


# ------------------------------------------------------------ checkpoints


def _assert_adam_equal(got, want):
    assert got["count"] == want["count"]
    for i, st in want["adam"]["state"].items():
        for k, v in st.items():
            assert torch.equal(got["adam"]["state"][i][k], v), (i, k)


def test_checkpoints_cross_tp(setup, world2, world4):
    """A tp-2 checkpoint restores at tp 1 to the one-process state after
    the same step (weights by the train rule, Adam's moments close) and
    at tp 4 bit for bit; a tp-1 checkpoint restores at tp 2 bit for bit,
    and the next step equals one process's."""
    s = setup
    d, cfg = s["d"], s["cfg"]
    one = ttrainer.create_train_state(cfg, CPU)
    assert CheckpointManager(f"{d}/tp2").restore(one, 1) is one
    ts, _ = _one_process(cfg, s["params"], s["state"], s["batches"][:1])
    _assert_trees_close(convert.to_jax_params(one.model),
                        convert.to_jax_params(ts.model), 1, cfg.lr)
    payload = CheckpointManager(f"{d}/tp2").load_payload(1)
    got = world4[2]["tp4_from_tp2"]
    for n, v in payload["model"].items():
        assert torch.equal(got["restored"][n], v), n
    _assert_adam_equal(got["restored_adam"], payload["optimizer"])
    tp1 = CheckpointManager(f"{d}/tp1").load_payload(1)
    got = world2[1]["from_tp1"]
    for n, v in tp1["model"].items():
        assert torch.equal(got["restored"][n], v), n
    _assert_adam_equal(got["restored_adam"], tp1["optimizer"])
    cont = ttrainer.create_train_state(cfg, CPU)
    CheckpointManager(f"{d}/tp1").restore(cont, 1)
    m = ttrainer.train_step(cont, tuple(map(torch.from_numpy,
                                            s["batches"][1])), cfg)
    for k in ("loss", "grad_norm"):
        _close(got[k][0], m[k].item(), RTOL, k)


def test_dp2tp2_checkpoint_is_whole(setup, world4):
    payload = CheckpointManager(f"{setup['d']}/dp2tp2").load_payload(1)
    model = tlas.LAS(setup["cfg"])
    model.load_state_dict(payload["model"])
    for n, v in world4[0]["dp2tp2"]["state"].items():
        assert torch.equal(payload["model"][n], v), n
    assert len(payload["rank_generators"]) == 2


def test_imported_checkpoint_steps_at_tp2_as_jax(setup, world2):
    """An exporter-format import (three JAX steps) restored at tp 2: the
    restored weights are the import's, and the next step on the import's
    fourth batch (padded by a copy of its first row) agrees with one
    process resuming the same directory."""
    s = setup
    got = world2[0]["import"]
    payload = CheckpointManager(f"{s['d']}/imported").load_payload(2)
    for n, v in payload["model"].items():
        assert torch.equal(got["restored"][n], v), n
    one = ttrainer.create_train_state(s["cfg"], CPU)
    CheckpointManager(f"{s['d']}/imported").restore(one, 2)
    m = ttrainer.train_step(one, tuple(map(torch.from_numpy,
                                           s["batches"][2])), s["cfg"])
    for k in ("loss", "grad_norm"):
        _close(got[k][0], m[k].item(), RTOL, k)


# --------------------------------------------------------------- the CLI


def test_train_cli_at_num_partitions_2_matches_one_process(cli_dir):  # noqa: F811,E501
    d = cli_dir

    def run(attempt):
        root = f"{d}/tp_run{attempt}"
        return root, _finish(_spawn(_CLI, lambda r: _cli_argv(
            d, r, *_THREE_STEPS, "--num_partitions", "2",
            "--save_dir", f"{root}/model",
            "--summary_dir", f"{root}/summary{r}")))

    root, outs = _retrying(run)
    hists = [_hist(o) for o in outs]
    assert hists[0] == hists[1] and hists[0]["step"] == 3
    assert "mesh: {'data': 1, 'model': 2} over 2 processes, backend gloo" \
        in outs[0]
    _, want = train_cli.main(["--device", "cpu"] + cli_args(d) + [
        "--save_dir", f"{d}/tp_model_one", "--summary_dir", f"{d}/tp_s_one",
        *_THREE_STEPS])
    for k in ("loss", "grad_norm"):
        _close(hists[0][k], want[k], RTOL, k)
    assert sorted(os.listdir(f"{root}/model")) == ["1.pt", "config.json"]
    cfg = json.load(open(f"{root}/model/config.json"))
    assert cfg["num_partitions"] == 2


def test_sigterm_to_rank_1_at_num_partitions_2(cli_dir):  # noqa: F811
    """tests/test_torch_distributed.py's SIGTERM to rank 1 alone, at
    --num_partitions 2: both ranks stop at the same logging step and both
    reach the checkpoint's gather of the split state (a collective), the
    primary writes it, and one process resumes from it."""
    _sigterm_to_rank_1(cli_dir, "model_term_tp", "--num_partitions", "2")


# ------------------------------------------------------------ evaluation


def _eval_setup(rng):
    cfg = small_cfg(ctc=True, beam_logprob=True, ctc_beam_weight=0.5,
                    lm_weight=0.5)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    audio = torch.from_numpy(
        rng.standard_normal((8, 32, 13, 3)).astype(np.float32))
    audiolen = torch.tensor([32, 30, 28, 32, 17, 32, 25, 32],
                            dtype=torch.int32)
    lm_cfg = tcr.LMConfig(vocab_size=28, hidden_size=16, num_layers=2,
                          model="lstm", embedding_size=8)
    lm = tcr.init(lm_cfg, torch.Generator().manual_seed(1), CPU)
    return cfg, model, audio, audiolen, lm, lm_cfg


@pytest.mark.parametrize("positions,k", [(2, 2), (4, 2), (4, 4)])
@pytest.mark.parametrize("int8", [False, True])
def test_eval_over_split_replicas_matches_one_device(rng, positions, k,
                                                     int8):
    """Greedy logits and tokens, and beam 4 with the fusion LM and joint
    CTC, over `positions` CPU positions at num_partitions k (positions / k
    replicas, each split over k; two replicas are two worker processes),
    against one device."""
    cfg, model, audio, audiolen, lm, lm_cfg = _eval_setup(rng)
    if int8:
        cfg = cfg.replace(quantize_decoder="int8")
        model, lm = quant.maybe_quantize(model, cfg), quant.quantize_lm(
            lm, lm_cfg)
    mesh = make_mesh(devices=[CPU] * positions, num_partitions=k)
    reps = sharding.place_eval_params(mesh, model, lm)
    assert len(reps) == positions // k
    cell = reps[0].model.speller.cells[0]
    assert isinstance(cell, tp.ColumnQuantLinear if int8
                      else tp.ColumnLinear)
    assert tp.axis_of(reps[0].lm.cells[0]).size == k
    want_logits, want = ttrainer.eval_forward(model, audio, audiolen, cfg, 10)
    kw = dict(cfg=cfg, max_steps=10, beam_size=4, logprob=True,
              lm_cfg=lm_cfg)
    want_beam = tbeam.beam_search(model, audio, audiolen, lm=lm, **kw)
    with workers.EvalPool(mesh, cfg, model, lm, lm_cfg) as pool:
        assert [d["split"] for d in pool.describe()] == [k] * (positions
                                                               // k)
        logits, y_hat = pool.run_split("greedy", (audio, audiolen),
                                       steps=10)
        got = pool.run_split("beam", (audio, audiolen), beam_size=4,
                             steps=10)
    torch.testing.assert_close(logits, want_logits, rtol=1e-5, atol=1e-5)
    assert torch.equal(y_hat, want)
    assert torch.equal(got.tokens[:, 0], want_beam.tokens[:, 0])
    assert torch.equal(got.lengths, want_beam.lengths)
    torch.testing.assert_close(got.scores, want_beam.scores, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("beam_size", [0, 4])
def test_recognizer_at_num_partitions_2(rng, beam_size):
    cfg = small_cfg(ctc=True, beam_logprob=True, ctc_beam_weight=0.5)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    sigs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (5000, 9000, 7000)]
    one = Recognizer(model, cfg, CharEncoder(), "cpu")
    split = Recognizer(model, cfg.replace(num_partitions=2), CharEncoder(),
                       "cpu,cpu")
    assert split.mesh.shape == {"data": 1, "model": 2}
    # one replica, inline, split over the two positions
    assert split.pool.describe() == [{"devices": ["cpu", "cpu"],
                                      "split": 2, "pid": None}]
    assert split.transcribe_signals(sigs, beam_size=beam_size) == \
        one.transcribe_signals(sigs, beam_size=beam_size)


def _eval_flags(d, log_dir):
    return MODEL_FLAGS + ["--shard_dir", d, "--split", "dev",
                          "--save_dir", d + "/model", "--log_dir", log_dir]


def test_test_decode_and_transcribe_clis_at_num_partitions_2(
        assets, capsys, tmp_path, rng):  # noqa: F811
    """test (greedy), decode (beam 3, LM fusion, joint CTC) and transcribe
    (beam 3 with the LM, through Recognizer.from_checkpoint) over
    `--device cpu,cpu --num_partitions 2` give one device's hypotheses."""
    d = assets
    preds = {}
    wavs = _wavs(str(tmp_path), rng)
    for name, extra in (("one", ["--device", "cpu"]),
                        ("split", ["--device", "cpu,cpu",
                                   "--num_partitions", "2"])):
        preds[name] = "\n".join(transcribe_cli.main(
            wavs + extra + MODEL_FLAGS + [
                "--save_dir", d + "/model", "--beam_size", "3",
                "--beam_logprob", "True", "--apply_lm", "True",
                "--lm_dir", d + "/lm"]))
        log_dir = os.path.join(d, f"log_tp_test_{name}")
        res = test_cli.main(extra + _eval_flags(d, log_dir))
        assert res.utterances == 6 and res.skipped == 0
        preds[name] += open(f"{log_dir}/test_pred.txt").read()
        log_dir = os.path.join(d, f"log_tp_decode_{name}")
        decode_cli.main(extra + _eval_flags(d, log_dir) + [
            "--lm_dir", d + "/lm", "--apply_lm", "True",
            "--lm_weight", "0.5", "--ctc_beam_weight", "0.5",
            "--beam_size", "3", "--beam_logprob", "True",
            "--decode_batch", "3", "--decode_pad_quantum", "32"])
        preds[name] += open(f"{log_dir}/decode_pred.txt").read()
    capsys.readouterr()
    assert preds["split"] == preds["one"]

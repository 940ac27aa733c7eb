"""Evaluation over a data axis (automatic_speech_recognition_torch/parallel/
mesh.py, sharding.py and workers.py), mirroring tests/test_sharding.py's
eval cases on a mesh that lists the CPU twice: two replicas, each in a
worker process of its own; the rows of a batch are split over them and
gathered back in order.  Greedy tokens and beam rank 0 (joint CTC) must
equal one device's row for row, logits within 1e-5 (float32, the same
arithmetic on fewer rows); the test and decode entry points and the
Recognizer give the same hypotheses over `--device cpu,cpu` as over
`--device cpu`.  Plain 'cuda' is every visible GPU."""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import os

import numpy as np
import pytest
import torch

from automatic_speech_recognition_torch import decode as decode_cli
from automatic_speech_recognition_torch import test as test_cli
from automatic_speech_recognition_torch.api import Recognizer
from automatic_speech_recognition_torch.decoding import beam as tbeam
from automatic_speech_recognition_torch.models import char_rnn as tcr
from automatic_speech_recognition_torch.models import las as tlas
from automatic_speech_recognition_torch.ops import quant
from automatic_speech_recognition_torch.parallel import sharding, workers
from automatic_speech_recognition_torch.parallel.mesh import (devices_for,
                                                              make_mesh)
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.utils.tokenizer import CharEncoder

from test_torch_decode_cli import MODEL_FLAGS, assets  # noqa: F401
from test_torch_las import small_cfg

CPU = torch.device("cpu")
TWO = make_mesh(devices=[CPU, CPU])
ONE = make_mesh(devices=[CPU])


def _eval_setup(rng, ctc=False):
    """test_sharding._eval_setup: 8 rows of ragged lengths."""
    cfg = small_cfg(ctc=ctc, beam_logprob=True,
                    ctc_beam_weight=0.5 if ctc else 0.0)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    audio = torch.from_numpy(
        rng.standard_normal((8, 32, 13, 3)).astype(np.float32))
    audiolen = torch.tensor([32, 30, 28, 32, 17, 32, 25, 32],
                            dtype=torch.int32)
    return cfg, model, audio, audiolen


def test_make_mesh_shapes():
    assert TWO.shape == {"data": 2, "model": 1} and TWO.size == 2
    four = make_mesh(devices=[CPU] * 4, data_axis="d", model_axis="m")
    assert four.shape == {"d": 4, "m": 1}
    assert make_mesh(num_devices=2, devices=[CPU] * 4).shape["data"] == 2
    assert devices_for("cpu,cpu") == [CPU, CPU]
    assert devices_for("cpu") == [CPU]
    # a model axis of 2: two replicas, each split over two positions
    split = make_mesh(devices=[CPU] * 4, num_partitions=2)
    assert split.shape == {"data": 2, "model": 2} and split.size == 4
    assert split.replica_devices() == [[CPU, CPU], [CPU, CPU]]
    with pytest.raises(ValueError, match="4 devices not divisible by 3"):
        make_mesh(devices=[CPU] * 4, num_partitions=3)


def test_a_gpu_mesh_without_a_gpu_raises(monkeypatch):
    """A GPU device or a list of them, and no GPU is an error, never the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in ("cuda", "cuda:0", "cuda:0,cuda:1"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            devices_for(name)


def test_plain_cuda_is_every_gpu(monkeypatch):
    """'cuda' is every visible GPU, as jax.devices() is every local
    device: three on a host of three, one on a host of one; 'cuda:N' is
    one GPU and a comma list those."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert devices_for("cuda") == [torch.device("cuda", i) for i in range(3)]
    assert make_mesh(devices=devices_for("cuda")).shape["data"] == 3
    assert devices_for("cuda:2") == [torch.device("cuda", 2)]
    assert devices_for("cuda:0,cuda:1") == [torch.device("cuda", 0),
                                            torch.device("cuda", 1)]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert devices_for("cuda") == [torch.device("cuda", 0)]
    assert make_mesh(devices=devices_for("cuda")).size == 1


@pytest.mark.parametrize("n,multiple,want", [
    (8, 2, 8), (7, 2, 8), (1, 4, 4), (5, 1, 5), (0, 2, 0), (9, 0, 9)])
def test_pad_batch_to(n, multiple, want):
    assert sharding.pad_batch_to(n, multiple) == want


def test_split_and_gather_keep_row_order(rng):
    x = torch.arange(12).reshape(6, 2)
    chunks = sharding.split_rows((x, x[:, 0].numpy()), 2)
    assert [c[0].shape for c in chunks] == [(3, 2), (3, 2)]
    assert torch.equal(sharding.gather_rows([c[0] for c in chunks], CPU), x)
    assert torch.equal(sharding.gather_rows([c[1] for c in chunks], CPU),
                       x[:, 0])
    with pytest.raises(ValueError, match="pad_batch_to"):
        sharding.split_rows((x[:5],), 2)
    res = [tbeam.BeamResult(torch.zeros(3, 2, 4), torch.ones(3, 2),
                            torch.zeros(3, 2), s) for s in (5, 9)]
    got = sharding.gather_rows(res, CPU)
    assert isinstance(got, tbeam.BeamResult) and got.steps == 9
    assert got.tokens.shape == (6, 2, 4)


def test_replicas_carry_statistics_int8_weights_and_the_lm(rng):
    """The second replica is a worker process's rebuild of the model and
    the LM: int8 cells, moved BN statistics and the LM's weights as the
    parent holds them; the first is the parent's own model."""
    cfg = small_cfg(apply_bn=True, quantize_decoder="int8")
    model = quant.maybe_quantize(
        tlas.init(cfg, torch.Generator().manual_seed(0), CPU), cfg)
    bn = model.listener.layers[0].bn_main
    bn.mean.add_(0.5)
    lm_cfg = tcr.LMConfig(vocab_size=28, hidden_size=16, num_layers=2,
                          model="lstm")
    lm = tcr.init(lm_cfg, torch.Generator().manual_seed(1), CPU)
    reps = sharding.place_eval_params(TWO, model, lm)
    assert len(reps) == 2 and reps[0].model is model and reps[0].lm is lm
    with workers.EvalPool(TWO, cfg, model, lm, lm_cfg) as pool:
        assert pool.size == 2 and len(pool.describe()) == 2
        sd, lm_sd = pool.submit("state_dict", (), worker=1).result()
    assert sd["speller.cells.0.q"].dtype == torch.int8
    assert torch.equal(sd["listener.layers.0.bn_main.mean"], bn.mean)
    for (k, a), b in zip(lm.state_dict().items(), lm_sd.values()):
        assert torch.equal(a, b), k


@pytest.fixture(scope="module")
def two_pools():
    """Pools of one model with a CTC head over one device and over the
    CPU listed twice (two worker processes)."""
    cfg = small_cfg(ctc=True, beam_logprob=True, ctc_beam_weight=0.5)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    with workers.EvalPool(TWO, cfg, model) as pool:
        yield cfg, model, pool


def test_greedy_over_the_mesh_matches_one_device(two_pools):
    cfg, model, pool = two_pools
    audio, audiolen = _eval_setup(np.random.default_rng(0))[2:]
    want_logits, want = trainer.eval_forward(model, audio, audiolen, cfg, 10)
    logits, y_hat = pool.run_split("greedy", (audio, audiolen), steps=10)
    torch.testing.assert_close(logits, want_logits, rtol=1e-5, atol=1e-5)
    assert torch.equal(y_hat, want)


def test_beam_over_the_mesh_matches_one_device(two_pools):
    cfg, model, pool = two_pools
    audio, audiolen = _eval_setup(np.random.default_rng(0), ctc=True)[2:]
    kw = dict(cfg=cfg, max_steps=10, beam_size=4, logprob=True)
    want = tbeam.beam_search(model, audio, audiolen, **kw)
    got = pool.run_split("beam", (audio, audiolen), beam_size=4, steps=10)
    assert torch.equal(got.tokens[:, 0], want.tokens[:, 0])
    assert torch.equal(got.lengths, want.lengths)
    torch.testing.assert_close(got.scores, want.scores, rtol=1e-5,
                               atol=1e-5)


@pytest.fixture(scope="module")
def recognizers():
    cfg = small_cfg(ctc=True, beam_logprob=True, ctc_beam_weight=0.5)
    model = tlas.init(cfg, torch.Generator().manual_seed(0), CPU)
    one = Recognizer(model, cfg, CharEncoder(), "cpu")
    with Recognizer(model, cfg, CharEncoder(), "cpu,cpu") as two:
        yield one, two


@pytest.mark.parametrize("beam_size", [0, 4])
def test_recognizer_over_two_devices_matches_one(rng, beam_size,
                                                 recognizers):
    """Three requests over two devices: a row of 1-sample silence pads the
    batch, and its hypothesis is dropped."""
    one, two = recognizers
    sigs = [(rng.standard_normal(n) * 0.1).astype(np.float32)
            for n in (5000, 9000, 7000)]
    assert two.mesh.shape["data"] == 2 and two.pool.size == 2
    assert one.pool.size == 1 and one.pool.describe()[0]["pid"] is None
    want = one.transcribe_signals(sigs, beam_size=beam_size)
    assert two.transcribe_signals(sigs, beam_size=beam_size) == want
    assert len(want) == 3


def _eval_flags(d, log_dir):
    return MODEL_FLAGS + ["--shard_dir", d, "--split", "dev",
                          "--save_dir", d + "/model", "--log_dir", log_dir]


def test_test_cli_over_two_devices_matches_one(assets):  # noqa: F811
    """Six dev utterances in one bucket: a batch of 6 over two replicas,
    greedy attention and CTC best-path, the same hypotheses in order."""
    for decoder in ("attention", "ctc_greedy"):
        res = {}
        for name in ("cpu", "cpu,cpu"):
            log_dir = os.path.join(assets, f"log_test_{decoder}_{name}")
            res[name] = test_cli.main(
                ["--device", name, "--eval_decoder", decoder]
                + _eval_flags(assets, log_dir))
            res[name + "pred"] = open(f"{log_dir}/test_pred.txt").read()
        assert res["cpu,cpu"].utterances == res["cpu"].utterances == 6
        assert res["cpu,cpu"].wer == res["cpu"].wer
        assert res["cpu,cpupred"] == res["cpupred"]


def test_decode_cli_over_two_devices_matches_one(assets, capsys):  # noqa: F811
    """Beam 3 with the fusion LM and joint CTC, batches of 3 (odd: each is
    padded by a 1-frame row) over two replicas."""
    preds = {}
    for name in ("cpu", "cpu,cpu"):
        log_dir = os.path.join(assets, f"log_decode_{name}")
        decode_cli.main(["--device", name] + _eval_flags(assets, log_dir) + [
            "--lm_dir", assets + "/lm", "--apply_lm", "True",
            "--lm_weight", "0.5", "--ctc_beam_weight", "0.5",
            "--beam_size", "3", "--beam_logprob", "True",
            "--decode_batch", "3", "--decode_pad_quantum", "32"])
        preds[name] = open(f"{log_dir}/decode_pred.txt").read().splitlines()
    capsys.readouterr()
    assert len(preds["cpu"]) == 6 and preds["cpu,cpu"] == preds["cpu"]

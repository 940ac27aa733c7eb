"""The port's CheckpointManager (automatic_speech_recognition_torch/
training/checkpoint.py), mirroring the JAX package's checkpoint tests
(tests/test_train_eval.py): a restored state continues exactly as the
uninterrupted one did, an overwrite is crash-safe, old epochs are pruned,
and a weights-only restore hands the JAX package trees it can evaluate.
"""

import torch_cpu  # noqa: F401  one CPU thread a process (keep it first)

import os

import numpy as np
import pytest
import torch

from automatic_speech_recognition_tpu.training import trainer as jtrainer
from automatic_speech_recognition_torch.training import trainer
from automatic_speech_recognition_torch.training.checkpoint import (
    CheckpointManager)

from test_torch_las import jax_cfg, small_cfg
from test_torch_train import make_batch

CPU = torch.device("cpu")


def _batch(rng):
    return tuple(map(torch.from_numpy, make_batch(rng)))


@pytest.mark.parametrize("accum", [1, 2])
def test_resumed_run_equals_the_uninterrupted_one(tmp_path, rng, accum):
    """Dropout and variational noise on, so the generator state matters;
    with accum 2 the save falls between micro-steps, so the accumulator
    matters too."""
    cfg = small_cfg(dropout_rate=0.2, add_vn=True, grad_accum_steps=accum)
    batches = [_batch(rng) for _ in range(6)]
    ts = trainer.create_train_state(cfg, CPU)
    for b in batches[:3]:
        trainer.train_step(ts, b, cfg)
    cm = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    cm.save(1, ts)
    straight = [trainer.train_step(ts, b, cfg)["loss"] for b in batches[3:]]
    fresh = trainer.create_train_state(cfg.replace(seed=7), CPU)
    restored = cm.restore(fresh)
    assert restored is fresh and restored.step == 3
    resumed = [trainer.train_step(fresh, b, cfg)["loss"]
               for b in batches[3:]]
    torch.testing.assert_close(torch.stack(resumed), torch.stack(straight),
                               rtol=0, atol=0)
    for a, b in zip(ts.model.state_dict().values(),
                    fresh.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_overwrite_is_crash_safe(tmp_path):
    cfg = small_cfg()
    d = str(tmp_path / "ckpt")
    cm = CheckpointManager(d)
    ts = trainer.create_train_state(cfg, CPU)
    cm.save(1, ts)
    # overwriting an epoch must not crash and must win cleanly
    ts.step = 7
    cm.save(1, ts)
    got = cm.restore(trainer.create_train_state(cfg, CPU), epoch=1)
    assert got.step == 7
    assert os.listdir(d) == ["1.pt"]
    cm.close()
    # a crash mid-overwrite leaves a torn temp file beside the old copy:
    # restore reads the old copy, the next save replaces the temp file
    with open(os.path.join(d, "1.pt.tmp"), "wb") as f:
        f.write(b"torn")
    cm2 = CheckpointManager(d)
    assert cm2.all_epochs() == [1]
    got = cm2.restore(trainer.create_train_state(cfg, CPU))
    assert got is not None and got.step == 7
    cm2.save(1, got)
    assert os.listdir(d) == ["1.pt"]


def test_max_to_keep_prunes_the_oldest_epochs(tmp_path):
    cfg = small_cfg()
    cm = CheckpointManager(str(tmp_path), max_to_keep=2)
    ts = trainer.create_train_state(cfg, CPU)
    assert cm.latest_epoch() is None
    assert cm.restore(ts) is None
    for epoch in (1, 2, 3, 4):
        ts.step = epoch
        cm.save(epoch, ts)
    assert cm.all_epochs() == [3, 4] and cm.latest_epoch() == 4
    assert cm.restore(ts, epoch=1) is None
    assert cm.restore(ts, epoch=3).step == 3


def test_restore_for_eval_hands_jax_the_trained_weights(tmp_path, rng):
    """Weights-only restore into a fresh model, returned as JAX trees: the
    JAX package's greedy forward on them equals the port's."""
    cfg = small_cfg(apply_bn=True)
    ts = trainer.create_train_state(cfg, CPU)
    batch = _batch(rng)
    for _ in range(2):
        trainer.train_step(ts, batch, cfg)
    cm = CheckpointManager(str(tmp_path))
    cm.save(1, ts)
    fresh = trainer.create_train_state(cfg.replace(seed=3), CPU).model
    params, bn_state = cm.restore_for_eval(fresh)
    x, xl = batch[0].numpy(), batch[1].numpy()
    want, _ = jtrainer.eval_forward(params, bn_state, x, xl, jax_cfg(cfg), 6)
    got, _ = trainer.eval_forward(ts.model, batch[0], batch[1], cfg, 6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    for a, b in zip(ts.model.state_dict().values(),
                    fresh.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert CheckpointManager(str(tmp_path / "empty")).restore_for_eval(
        fresh) is None

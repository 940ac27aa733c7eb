"""Epoch checkpoints of the train state (counterpart of
automatic_speech_recognition_tpu/training/checkpoint.py, same interface).

One file per epoch, `<dir>/<epoch>.pt`, written by torch.save: the model's
state dict (weights, BN moving statistics), the optimizer's state (Adam
moments, update count, MultiSteps accumulator), the micro-step count and
the generators' states (the LAS state's augmentation generator beside the
main one); `save` and `restore` take the LAS TrainState and the language
model's LMTrainState (models/char_rnn.py) alike.  A LAS checkpoint written
before the augmentation generator existed restores with that generator
as the state was created (seeded from cfg.seed).  `save_weights` writes
the state dict alone, which
`load_weights` reads (as every evaluation restore does).  A save writes
`<epoch>.pt.tmp` and renames it over the target with os.replace, so a
crash mid-save leaves the previous copy of that epoch whole; restore
ignores the torn temp file and the next save replaces it.  The oldest
epochs beyond max_to_keep are deleted after each save.

Under data parallelism (a torch.distributed group of several processes)
every process calls `save`, `save_weights` and `restore`, as every JAX
process calls its manager: the primary alone writes, replaces and prunes,
and the others wait for it at a barrier; every process restores.  The
state is the same on every rank except the per-rank generators (dropout
and augmentation streams), which a save gathers from every rank into the
file (`rank_generators`, `aug_generators`) and a restore hands back to
each rank by its index; a checkpoint of another world size leaves them
as seeded.  The weights are float32 whatever
cfg.dtype is (bf16 casts copies for the forward only), and an int8
(ops/quant) model is never written: quantization is applied to a restored
float checkpoint at inference.
"""

from __future__ import annotations

import os
import re
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from ..models.las import LAS
from ..parallel import distributed
from .trainer import TrainState

if TYPE_CHECKING:
    from ..models.char_rnn import LMTrainState
    AnyTrainState = Union[TrainState, LMTrainState]

_NAME = re.compile(r"^(\d+)\.pt$")
_TMP_SUFFIX = ".tmp"


class CheckpointManager:
    """Epoch-indexed TrainState checkpoints (the reference's `las_E{epoch}`,
    keeping max_to_keep)."""

    def __init__(self, directory: str, max_to_keep: int = 30):
        self._dir = os.path.abspath(directory)
        os.makedirs(self._dir, exist_ok=True)
        self.max_to_keep = max_to_keep

    def _path(self, epoch: int) -> str:
        return os.path.join(self._dir, f"{epoch}.pt")

    def save(self, epoch: int, state: "AnyTrainState",
             block: bool = True) -> None:
        """Save, overwriting an existing checkpoint of the same epoch.
        Always synchronous (`block` is kept for the interface): the state
        is copied to the host inside torch.save."""
        del block
        payload = {
            "model": state.model.state_dict(),
            "optimizer": state.optimizer.state_dict(),
            "step": state.step,
            "generator": state.generator.get_state(),
        }
        if isinstance(state, TrainState):
            payload["aug_generator"] = state.aug_generator.get_state()
            group = distributed.world_group()
            if group is not None:
                payload["rank_generators"] = distributed.gather_all(
                    state.rank_generator.get_state(), group)
                payload["aug_generators"] = distributed.gather_all(
                    state.aug_generator.get_state(), group)
        self._write(epoch, payload)

    def save_weights(self, epoch: int, model: nn.Module) -> None:
        """Save a model's weights alone, for evaluation (`load_weights`);
        `restore` cannot resume training from such a file."""
        self._write(epoch, {"model": model.state_dict()})

    def _write(self, epoch: int, payload: Dict) -> None:
        """The primary writes; every process leaves when the file is in
        place."""
        if any(k.endswith(".w_scale") for k in payload["model"]):
            raise ValueError("refusing to checkpoint an int8-quantized "
                             "model: quantization is for inference only")
        if distributed.is_primary():
            tmp = self._path(epoch) + _TMP_SUFFIX
            with open(tmp, "wb") as f:
                torch.save(payload, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._path(epoch))
            if self.max_to_keep > 0:
                for old in self.all_epochs()[:-self.max_to_keep]:
                    os.remove(self._path(old))
        distributed.barrier(f"checkpoint {epoch} written")

    def all_epochs(self) -> List[int]:
        """Committed epochs, ascending."""
        return sorted(int(m.group(1)) for m in map(_NAME.match,
                                                   os.listdir(self._dir))
                      if m)

    def latest_epoch(self) -> Optional[int]:
        epochs = self.all_epochs()
        return epochs[-1] if epochs else None

    def _load(self, epoch: int) -> Optional[Dict]:
        """The payload of `epoch` (-1 = latest), or None."""
        step = self.latest_epoch() if epoch < 0 else epoch
        if step is None or step not in self.all_epochs():
            return None
        return torch.load(self._path(step), map_location="cpu",
                          weights_only=True)

    def restore(self, state_like: "AnyTrainState", epoch: int = -1
                ) -> Optional["AnyTrainState"]:
        """Load the checkpoint into `state_like` (in place) and return it;
        epoch -1 = latest.  None if there is nothing to restore."""
        payload = self._load(epoch)
        if payload is None:
            return None
        state_like.model.load_state_dict(payload["model"])
        state_like.optimizer.load_state_dict(payload["optimizer"])
        state_like.step = int(payload["step"])
        state_like.generator.set_state(payload["generator"])
        if not isinstance(state_like, TrainState):
            return state_like
        rank, world = distributed.process_index(), distributed.process_count()
        if world == 1:
            if "aug_generator" in payload:
                state_like.aug_generator.set_state(payload["aug_generator"])
        elif len(payload.get("rank_generators", ())) == world:
            state_like.rank_generator.set_state(
                payload["rank_generators"][rank])
            state_like.aug_generator.set_state(
                payload["aug_generators"][rank])
        return state_like

    def load_weights(self, model_like: nn.Module, epoch: int = -1
                     ) -> Optional[nn.Module]:
        """Weights-only restore: load the weights (and BN statistics) into
        `model_like` and return it; optimizer state and generator are not
        read.  None if there is nothing to restore."""
        payload = self._load(epoch)
        if payload is None:
            return None
        model_like.load_state_dict(payload["model"])
        return model_like

    def restore_for_eval(self, model_like: LAS, epoch: int = -1
                         ) -> Optional[Tuple[Dict, Dict]]:
        """`load_weights` into `model_like`, returned as the JAX package's
        (params, bn_state) NumPy trees, which its evaluation scripts take.
        None if there is nothing to restore."""
        # imported here: models/convert imports the language model, whose
        # directory I/O imports this module
        from ..models import convert
        if self.load_weights(model_like, epoch) is None:
            return None
        return convert.to_jax_params(model_like)

    def close(self) -> None:
        """Nothing is in flight: every save is synchronous."""

"""Listen, Attend and Spell (counterpart of
automatic_speech_recognition_tpu/models/las.py).

- Listener 'cnn': 2 stride-2 SAME convs (time/4, feat/4) + ReLU, flatten
  (B, T, Dr, C) with C fastest, then N x {dropout -> BiRNN -> proj -> BN ->
  ReLU} (an extra BN per layer and after each conv when cfg.apply_bn).
  Lengths follow ceil_half twice.  Output width enc_units.
- Listener 'pblstm': (B, T, D, 3) flattened to (B, T, 3D), dropout, BiRNN,
  tanh(proj) (2u -> 2u), then N pyramid stages of {dropout -> BiRNN ->
  zero-pad an odd T by one frame at the padded tail -> concat even and odd
  frames (4u) -> tanh(proj) (4u -> 2u)}, lengths ceil_half per stage.
  Output width 2 enc_units (enc_out_dim); no BN state.  The BiRNNs run
  over the padding as the JAX scans do: sequences are never packed.
- Speller: embedding, stacked tanh RNN cells, additive or location-aware
  attention whose query is the concat of ALL layer states in layer order,
  output dense.  <SOS> (id 1) feeds the first step; states and the first
  alignment are zero.  Greedy inference feeds the argmax back; training
  feeds the teacher's y_t into step t + 1, or, under scheduled sampling,
  one batch-level coin per step (tf_rate > U(0, 1)) picks the teacher or
  a sample of the step's own distribution.  The fed embedding takes
  dropout and, with cfg.add_vn, variational noise per lookup.
- Losses: masked label-smoothed CE (eps 0.01) and the optional CTC (blank
  = vocab_size), with the JAX package's LR and tf-rate schedules;
  cfg.spec_augment masks the training features first
  (ops/augmentation.spec_augment), before the compute cast.
- cfg.dtype 'bfloat16': compute_cast runs the forward on bfloat16 copies
  of the float32 master parameters (and of the BiRNNs' zero bias_hh
  buffers); BN moving statistics and int8 w_scale buffers stay float32,
  so does every state the optimizer and checkpoints see.  Logits, alphas
  and CTC logits come back float32.

CUDA graphs of the teacher-forced speller (graphed_loop): where
graph_eligible holds (a CUDA device, pure teacher forcing, no dropout
and no variational noise, no remat, no speller module split over a model
axis, a loop autograd records, no capture under way), a batch shape's
third training call captures the whole loop, precompute_hidden included,
as a forward and a backward CUDA graph, and every later call of the
shape replays them inside one autograd node.
The graphs replay the kernels the eager loop launches, on the same
inputs, copied in by value; anything else runs the eager loop.

Host spans (utils/spans.py): `las.listener` around the listener's
forward, `las.speller` around a decoder loop (eager, or a replay with
its input copies and output clones) with its counter
`las.speller.steps` (every decoder step), and a fine `las.speller.step`
range an eager decoder step under a profiler.  Counters of the graphs:
`las.speller.graph_steps`, the decoder steps a replay ran, and
`las.speller.graph_captures`.

Training branches are chosen by an explicit is_training, never by
nn.Module.training (cuDNN's RNN backward needs train mode); randomness
comes from an explicit torch.Generator.
"""

from __future__ import annotations

import contextlib
import math
import threading
import weakref
from typing import Dict, Iterator, Optional, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn
from torch.autograd.function import once_differentiable
from torch.utils.checkpoint import checkpoint

from automatic_speech_recognition_torch.config import Config
from automatic_speech_recognition_torch.utils.tokenizer import PAD_ID, SOS_ID

from ..ops import attention as att
from ..ops import augmentation
from ..ops import layers as L
from ..parallel import distributed
from ..parallel import tensor_parallel as tp
from ..utils import spans

# new BN moving statistics by module name under the model ("listener....")
BNState = Dict[str, Tuple[torch.Tensor, torch.Tensor]]
# optax.ctc_loss's log(+0): an infeasible alignment costs about -LOG_EPSILON
LOG_EPSILON = -1e5


def ceil_half(x):
    """(x + x % 2) / 2 — the reference's length reduction."""
    return (x + x % 2) // 2


def enc_out_dim(cfg: Config) -> int:
    """The listener's output width: enc_units for 'cnn', 2 enc_units for
    'pblstm'."""
    return cfg.enc_units if cfg.enc_type == "cnn" else 2 * cfg.enc_units


def compute_dtype(cfg: Config) -> torch.dtype:
    if cfg.dtype not in ("float32", "bfloat16"):
        raise ValueError(f"--dtype must be 'float32' or 'bfloat16', got "
                         f"{cfg.dtype!r}")
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


# compute_cast swaps the tensors of a shared model: one cast of a model at
# a time (serving's batcher and its callers may share a Recognizer), while
# the replicas of a data axis cast at once
_CAST_LOCKS: "weakref.WeakKeyDictionary[nn.Module, threading.RLock]" = \
    weakref.WeakKeyDictionary()
_CAST_LOCKS_GUARD = threading.Lock()


def _cast_lock(model: nn.Module) -> threading.RLock:
    with _CAST_LOCKS_GUARD:
        return _CAST_LOCKS.setdefault(model, threading.RLock())


@contextlib.contextmanager
def _tensors_in(slots, tensors) -> Iterator[None]:
    """The tensors of `slots`, (parameter or buffer table, name) pairs,
    swapped for `tensors` inside the block."""
    saved = [table[name] for table, name in slots]
    try:
        for (table, name), t in zip(slots, tensors):
            table[name] = t
        yield
    finally:
        for (table, name), t in zip(slots, saved):
            table[name] = t


@contextlib.contextmanager
def compute_cast(cfg: Config, model: nn.Module) -> Iterator[None]:
    """Mixed precision, as the JAX package's compute_cast: under
    cfg.dtype 'bfloat16', inside the block the model's float32 parameters
    and its RNNs' zero bias_hh buffers are bfloat16 copies, which autograd
    links to the float32 masters (gradients land in float32).  BN moving
    statistics, int8 weights and their float32 w_scale are left as they
    are.  float32 is a no-op; a nested cast of the same model too.  A
    backward that recomputes the forward (cfg.remat) must run inside the
    same block.  Casts of one model from several threads take turns; a
    float32 caller sharing the model meanwhile would see the copies, so a
    model serves one dtype at a time."""
    if compute_dtype(cfg) == torch.float32:
        yield
        return
    with _cast_lock(model):
        if getattr(model, "_cast_active", False):
            yield
            return
        slots = []
        for mod in model.modules():
            tables = [mod._parameters]
            if isinstance(mod, nn.RNN):
                tables.append(mod._buffers)
            slots += [(table, name) for table in tables
                      for name, t in table.items()
                      if t is not None and t.dtype == torch.float32]
        with _tensors_in(slots, [table[name].to(torch.bfloat16)
                                 for table, name in slots]):
            model._cast_active = True
            try:
                yield
            finally:
                model._cast_active = False


class ListenerLayer(nn.Module):
    def __init__(self, in_dim: int, units: int, apply_bn: bool):
        super().__init__()
        self.birnn = L.make_birnn(in_dim, units)
        self.proj = nn.Linear(2 * units, units)
        self.bn_extra = L.BatchNorm(units) if apply_bn else None
        self.bn_main = L.BatchNorm(units)

    def forward(self, x: torch.Tensor, is_training: bool = False,
                group: distributed.Group = None
                ) -> Tuple[torch.Tensor, BNState]:
        x = self.proj(L.birnn_apply(self.birnn, x))
        state: BNState = {}
        if self.bn_extra is not None:
            x, state["bn_extra"] = self.bn_extra.normalize(x, is_training,
                                                           group)
        x, state["bn_main"] = self.bn_main.normalize(x, is_training, group)
        return torch.relu(x), state


class Listener(nn.Module):
    """CNN listener: (B, T, D, 3) features -> (B, T', enc_units)."""

    def __init__(self, cfg: Config):
        super().__init__()
        C = cfg.num_enc_channels
        self.conv0 = nn.Conv2d(3, C, 3, stride=2)
        self.conv1 = nn.Conv2d(C, C, 3, stride=2)
        self.bn_conv0 = L.BatchNorm(C) if cfg.apply_bn else None
        self.bn_conv1 = L.BatchNorm(C) if cfg.apply_bn else None
        d = ceil_half(ceil_half(cfg.feat_dim)) * C
        self.layers = nn.ModuleList()
        for _ in range(cfg.num_enc_layers):
            self.layers.append(ListenerLayer(d, cfg.enc_units, cfg.apply_bn))
            d = cfg.enc_units

    def forward(self, audio: torch.Tensor, audiolen: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Inference: (enc_out (B, T', H), enc_len (B,))."""
        x, audiolen, _ = self.encode(audio, audiolen)
        return x, audiolen

    def encode(self, audio: torch.Tensor, audiolen: torch.Tensor,
               is_training: bool = False, dropout_rate: float = 0.0,
               generator: Optional[torch.Generator] = None,
               group: distributed.Group = None
               ) -> Tuple[torch.Tensor, torch.Tensor, BNState]:
        """(enc_out, enc_len, new BN statistics by name under the
        listener); dropout runs before each BiRNN layer in training, and
        `group` makes the training BN statistics the global batch's."""
        x = audio                                   # NHWC, 3 channels
        state: BNState = {}
        for i, (conv, bn) in enumerate(((self.conv0, self.bn_conv0),
                                        (self.conv1, self.bn_conv1))):
            x = L.conv2d_layer(conv, x, stride=2)
            if bn is not None:
                x, state[f"bn_conv{i}"] = bn.normalize(x, is_training, group)
            x = torch.relu(x)
            audiolen = ceil_half(audiolen)
        B, T, Dr, C = x.shape
        x = x.reshape(B, T, Dr * C)
        for i, layer in enumerate(self.layers):
            x = L.dropout(x, dropout_rate, is_training, generator)
            x, layer_state = layer(x, is_training, group)
            state.update({f"layers.{i}.{k}": v
                          for k, v in layer_state.items()})
        return x, audiolen, state


class PyramidStage(nn.Module):
    def __init__(self, units: int):
        super().__init__()
        self.birnn = L.make_birnn(2 * units, units)
        self.proj = nn.Linear(4 * units, 2 * units)


class PBLSTMListener(nn.Module):
    """Pyramidal BiRNN listener: (B, T, D, 3) features ->
    (B, ceil(T / 2^N), 2 enc_units)."""

    def __init__(self, cfg: Config):
        super().__init__()
        u = cfg.enc_units
        self.birnn0 = L.make_birnn(3 * cfg.feat_dim, u)
        self.proj0 = nn.Linear(2 * u, 2 * u)
        self.pyr = nn.ModuleList(PyramidStage(u)
                                 for _ in range(cfg.num_enc_layers))

    def forward(self, audio: torch.Tensor, audiolen: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Inference: (enc_out (B, T', 2u), enc_len (B,))."""
        x, audiolen, _ = self.encode(audio, audiolen)
        return x, audiolen

    def encode(self, audio: torch.Tensor, audiolen: torch.Tensor,
               is_training: bool = False, dropout_rate: float = 0.0,
               generator: Optional[torch.Generator] = None,
               group: distributed.Group = None
               ) -> Tuple[torch.Tensor, torch.Tensor, BNState]:
        """(enc_out, enc_len, {}): the pyramid has no BN state, so it
        needs no group."""
        B, T, D, C = audio.shape
        x = L.dropout(audio.reshape(B, T, D * C), dropout_rate, is_training,
                      generator)
        x = torch.tanh(self.proj0(L.birnn_apply(self.birnn0, x)))
        for stage in self.pyr:
            x = L.birnn_apply(stage.birnn, L.dropout(
                x, dropout_rate, is_training, generator))
            if x.shape[1] % 2:
                x = F.pad(x, (0, 0, 0, 1))          # onto the padded tail
            x = torch.tanh(stage.proj(torch.cat([x[:, ::2], x[:, 1::2]],
                                                -1)))
            audiolen = ceil_half(audiolen)
        return x, audiolen, {}


class Speller(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        h_dim = enc_out_dim(cfg)
        self.embedding = nn.Embedding(cfg.vocab_size, cfg.embedding_size)
        self.attention = att.Attention(
            cfg.mode, h_dim, cfg.dec_units * cfg.num_dec_layers,
            cfg.attention_size, cfg.loc_kernel_size, cfg.loc_num_channels)
        self.out = nn.Linear(cfg.dec_units, cfg.vocab_size)
        in_dim = cfg.embedding_size + h_dim
        self.cells = nn.ModuleList()
        for _ in range(cfg.num_dec_layers):
            self.cells.append(nn.Linear(in_dim + cfg.dec_units,
                                        cfg.dec_units))
            in_dim = cfg.dec_units
        # trained with joint CTC; greedy attention decoding does not read it
        self.ctc_head = (nn.Linear(h_dim, cfg.vocab_size + 1) if cfg.ctc
                         else None)


def decode_step(sp: Speller, enc_out, enc_len, states, prev_emb, prev_align,
                h_proj=None):
    """One decoder step.  states: (L, B, U).  Returns (logits, new states,
    alphas)."""
    B = enc_out.shape[0]
    s_i = states.transpose(0, 1).reshape(B, -1)
    context, alphas = sp.attention(enc_out, s_i, prev_align, enc_len, h_proj)
    x = torch.cat([prev_emb, context], -1)
    new_states = []
    for l, cell in enumerate(sp.cells):
        x = L.rnn_cell_apply(cell, x, states[l])
        new_states.append(x)
    return sp.out(x), torch.stack(new_states), alphas


def speller_greedy(sp: Speller, enc_out, enc_len, dec_steps: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy argmax feedback for dec_steps.  Returns logits (B, steps, V)
    and alphas (B, steps, T_enc)."""
    B, T_enc, _ = enc_out.shape
    emb = L.embed(
        sp.embedding,
        torch.full((B,), SOS_ID, dtype=torch.long, device=enc_out.device))
    states = enc_out.new_zeros(len(sp.cells), B, sp.out.in_features)
    align = enc_out.new_zeros(B, T_enc)
    h_proj = att.precompute_hidden(sp.attention, enc_out)
    logits, alphas = [], []
    with spans.span("las.speller"):
        for _ in range(dec_steps):
            with spans.fine("las.speller.step"):
                lg, states, align = decode_step(sp, enc_out, enc_len, states,
                                                emb, align, h_proj)
                emb = L.embed(sp.embedding, lg.argmax(-1))
            logits.append(lg)
            alphas.append(align)
        spans.count("las.speller.steps", dec_steps)
    return torch.stack(logits, 1), torch.stack(alphas, 1)


def scheduled_sampling_rate(cfg: Config, step) -> torch.Tensor:
    """Teacher-forcing rate: 1.0 until warmup_step, then linear decay to
    min_rate at max_step (float32, as the JAX package computes it)."""
    if cfg.max_step <= cfg.warmup_step:
        # a negative decay window would silently INVERT the schedule
        raise ValueError(
            f"scheduled sampling needs max_step > warmup_step, got "
            f"warmup_step={cfg.warmup_step} max_step={cfg.max_step}")
    step = torch.as_tensor(step, dtype=torch.float32)
    progress = torch.clamp(
        (step - cfg.warmup_step) / float(cfg.max_step - cfg.warmup_step),
        max=1.0)
    return torch.clamp(1.0 - progress * (1.0 - cfg.min_rate), max=1.0)


def _pure_teacher_forcing(tf_rate: Union[float, torch.Tensor]) -> bool:
    return isinstance(tf_rate, float) and tf_rate >= 1.0


def speller_train(sp: Speller, cfg: Config, enc_out, enc_len,
                  teacher: torch.Tensor,
                  generator: Optional[torch.Generator] = None,
                  tf_rate: Union[float, torch.Tensor] = 1.0,
                  rank_generator: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Training decoder over teacher.shape[1] steps.  Returns logits
    (B, steps, V) and alphas (B, steps, T_enc).

    A float tf_rate >= 1.0 is pure teacher forcing; any other value (a
    tensor from scheduled_sampling_rate) draws the batch-level coin every
    step.  With cfg.remat each decoder step is recomputed in the backward
    pass instead of keeping its activations.  Draws for the whole batch
    (the coin, the variational noise on the table) come from `generator`;
    draws per row (the sampled tokens, dropout) from `rank_generator`,
    which defaults to `generator`: under data parallelism the first is
    the same on every rank and the second differs.  Where graph_eligible
    holds, the loop runs as its shape's CUDA graph pair (graphed_loop)."""
    if generator is None and (not _pure_teacher_forcing(tf_rate)
                              or cfg.dropout_rate > 0 or cfg.add_vn):
        # reusing fixed masks or coins every step would train silently
        # on the wrong distribution: refuse instead
        raise ValueError(
            "speller_train: a generator is required when training with "
            "scheduled sampling, dropout, or variational noise")
    per_row = rank_generator if rank_generator is not None else generator
    with spans.span("las.speller"):
        if graph_eligible(sp, cfg, tf_rate, enc_out):
            out = graphed_loop(sp, cfg, enc_out, enc_len, teacher)
        else:
            out = _teacher_loop(sp, cfg, enc_out, enc_len, teacher,
                                generator, tf_rate, per_row)
        spans.count("las.speller.steps", teacher.shape[1])
    return out


def _teacher_loop(sp: Speller, cfg: Config, enc_out, enc_len, teacher,
                  generator: Optional[torch.Generator] = None,
                  tf_rate: Union[float, torch.Tensor] = 1.0,
                  per_row: Optional[torch.Generator] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """speller_train's loop, eager, and the body its graph captures."""
    B, T_enc, _ = enc_out.shape
    dev = enc_out.device
    sampling = not _pure_teacher_forcing(tf_rate)
    if sampling:
        tf_rate = torch.as_tensor(tf_rate, dtype=torch.float32, device=dev)
    vn = generator if cfg.add_vn else None
    emb = L.embed(
        sp.embedding, torch.full((B,), SOS_ID, dtype=torch.long, device=dev),
        vn)
    states = enc_out.new_zeros(len(sp.cells), B, sp.out.in_features)
    align = enc_out.new_zeros(B, T_enc)
    h_proj = att.precompute_hidden(sp.attention, enc_out)
    logits, alphas = [], []
    for t in range(teacher.shape[1]):
        with spans.fine("las.speller.step"):
            if cfg.remat:
                lg, states, align = checkpoint(
                    decode_step, sp, enc_out, enc_len, states, emb, align,
                    h_proj, use_reentrant=False, preserve_rng_state=False)
            else:
                lg, states, align = decode_step(sp, enc_out, enc_len, states,
                                                emb, align, h_proj)
            ids = teacher[:, t].long()
            if sampling:
                coin = torch.rand((), generator=generator, device=dev)
                sampled = torch.multinomial(
                    torch.softmax(lg.detach().float(), -1), 1,
                    generator=per_row)[:, 0]
                ids = torch.where(tf_rate > coin, ids, sampled)
            emb = L.dropout(L.embed(sp.embedding, ids, vn),
                            cfg.dropout_rate, True, per_row)
        logits.append(lg)
        alphas.append(align)
    return torch.stack(logits, 1), torch.stack(alphas, 1)


def graph_eligible(sp: Speller, cfg: Config,
                   tf_rate: Union[float, torch.Tensor],
                   enc_out: torch.Tensor) -> bool:
    """Whether speller_train runs its loop through graphed_loop: on a
    CUDA device, under pure teacher forcing, with nothing in the loop
    that draws (no dropout, no variational noise), without remat, with
    no speller module split over a model axis (its collectives), where
    autograd records the loop (grad mode on, enc_out and every weight
    the loop reads requiring a gradient), and outside another capture."""
    return (enc_out.device.type == "cuda" and _pure_teacher_forcing(tf_rate)
            and cfg.dropout_rate == 0 and not cfg.add_vn and not cfg.remat
            and all(tp.axis_of(m) is None for m in sp.modules())
            and torch.is_grad_enabled() and enc_out.requires_grad
            and all(table[name].requires_grad
                    for table, name in _loop_slots(sp))
            and not torch.cuda.is_current_stream_capturing())


class GraphCache:
    """A speller's graph pairs by graph_key (before its capture, a
    shape's entry counts its eager calls), and what they share: the side
    stream they are captured on and one memory pool.  A pair's memory in
    the pool lives from its forward replay to its backward replay
    (outputs and gradients leave as clones), so the pairs of all shapes
    take turns with it, and a capture reuses what earlier ones allocated.
    `replays` counts the pool's forward replays: a backward checks that
    no other forward has run since its own."""

    def __init__(self):
        self.pairs: Dict[tuple, Union[int, "SpellerGraphs"]] = {}
        self.pool = None
        self.stream: Optional[torch.cuda.Stream] = None
        self.replays = 0


# keyed weakly: freeing the model frees its graphs and their memory pool
_GRAPHS: "weakref.WeakKeyDictionary[Speller, GraphCache]" = \
    weakref.WeakKeyDictionary()
# a shape's first calls run eager: they warm cuBLAS and the allocator up
# for it, and show that it recurs before a capture (about as much host
# time as two eager calls) is paid for
EAGER_CALLS = 2


def speller_graphs(sp: Speller) -> GraphCache:
    """The graph cache of `sp` (made empty on first use)."""
    return _GRAPHS.setdefault(sp, GraphCache())


def graph_key(enc_out: torch.Tensor, teacher: torch.Tensor) -> tuple:
    """(rows, T_enc, decoder steps, compute dtype, device): what a graph
    pair is captured for."""
    return (enc_out.shape[0], enc_out.shape[1], teacher.shape[1],
            enc_out.dtype, enc_out.device)


def _loop_slots(sp: Speller):
    """(parameter table, name) of every tensor the teacher-forced loop
    reads: the speller's parameters but the CTC head's.  Under
    compute_cast a table holds the bfloat16 copy."""
    return [(m._parameters, name) for path, m in sp.named_modules()
            if not path.startswith("ctc_head")
            for name, t in m._parameters.items() if t is not None]


@contextlib.contextmanager
def _capture(graph: torch.cuda.CUDAGraph, cache: GraphCache
             ) -> Iterator[None]:
    """Capture into `graph` on the cache's side stream and pool.
    torch.cuda.graph would also synchronize and empty the allocator's
    cache first, and the eager work after a capture would then allocate
    its memory anew.  thread_local: the loader's prefetcher copies
    batches to the device from its own thread meanwhile."""
    cache.stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(cache.stream):
        graph.capture_begin(pool=cache.pool,
                            capture_error_mode="thread_local")
        try:
            yield
        finally:
            graph.capture_end()


class SpellerGraphs:
    """One batch shape's teacher-forced loop, precompute_hidden included,
    captured as two CUDA graphs in the cache's pool: the forward (logits,
    alphas from enc_out, enc_len, the teacher ids and the loop's weights)
    and the backward (the gradients of enc_out and of each weight from
    those of logits and alphas).  Every input enters by value: forward()
    copies it into the graph's static buffer, so Adam's in-place update
    and compute_cast's fresh copies are both seen.  Outputs and gradients
    come back as clones.  A backward pairs with the latest forward replay
    in the pool, whose saved activations the pool holds."""

    def __init__(self, sp: Speller, cfg: Config, enc_out, enc_len, teacher,
                 weights, cache: GraphCache):
        if cache.pool is None:
            cache.pool = torch.cuda.graph_pool_handle()
            cache.stream = torch.cuda.Stream(enc_out.device)
        self.enc_out = enc_out.detach().clone().requires_grad_()
        self.enc_len = enc_len.clone()
        self.teacher = teacher.clone()
        self.weights = [w.detach().clone().requires_grad_() for w in weights]
        self.fwd, self.bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        try:
            with _capture(self.fwd, cache), \
                    _tensors_in(_loop_slots(sp), self.weights):
                self.logits, self.alphas = _teacher_loop(
                    sp, cfg, self.enc_out, self.enc_len, self.teacher)
            self.grad_logits = torch.empty_like(self.logits)
            self.grad_alphas = torch.empty_like(self.alphas)
            with _capture(self.bwd, cache):
                self.grads = torch.autograd.grad(
                    (self.logits, self.alphas), (self.enc_out, *self.weights),
                    (self.grad_logits, self.grad_alphas), allow_unused=True)
        except BaseException:
            # once no captured graph holds the pool, while it still holds
            # memory (this pair's, freed with the failed pair), the
            # allocator refuses another capture into it: the next capture
            # starts a new pool
            if all(isinstance(v, int) for v in cache.pairs.values()):
                cache.pool = None
            raise

    def forward(self, enc_out, enc_len, teacher, weights
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        with torch.no_grad():
            self.enc_out.copy_(enc_out)
            self.enc_len.copy_(enc_len)
            self.teacher.copy_(teacher)
            torch._foreach_copy_(self.weights, list(weights))
        self.fwd.replay()
        return self.logits.detach().clone(), self.alphas.detach().clone()

    def backward(self, grad_logits, grad_alphas) -> Tuple:
        for static, grad in ((self.grad_logits, grad_logits),
                             (self.grad_alphas, grad_alphas)):
            if grad is None:
                static.zero_()
            else:
                static.copy_(grad)
        self.bwd.replay()
        return tuple(g if g is None else g.clone() for g in self.grads)


class _Graphed(torch.autograd.Function):
    """A SpellerGraphs replay as an autograd node (the design of
    torch.cuda.make_graphed_callables): inputs (cache, graphs, enc_out,
    enc_len, teacher, *weights), outputs (logits, alphas)."""

    @staticmethod
    def forward(ctx, cache, graphs, enc_out, enc_len, teacher, *weights):
        ctx.set_materialize_grads(False)
        out = graphs.forward(enc_out, enc_len, teacher, weights)
        cache.replays += 1
        ctx.cache, ctx.graphs, ctx.replay = cache, graphs, cache.replays
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, grad_logits, grad_alphas):
        if ctx.replay != ctx.cache.replays:
            raise RuntimeError(
                "a later replay of the speller's graphs overwrote the "
                "activations this backward needs")
        grad_enc, *grad_w = ctx.graphs.backward(grad_logits, grad_alphas)
        return (None, None, grad_enc, None, None, *grad_w)


def graphed_loop(sp: Speller, cfg: Config, enc_out, enc_len, teacher
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The teacher-forced loop through its shape's graph pair, where
    graph_eligible holds: the first EAGER_CALLS calls of a shape run
    eager, the next captures the pair and replays it, later ones replay.
    Counters: `las.speller.graph_captures`, and `las.speller.graph_steps`
    for the decoder steps a replay ran."""
    weights = [table[name] for table, name in _loop_slots(sp)]
    cache = speller_graphs(sp)
    key = graph_key(enc_out, teacher)
    graphs = cache.pairs.get(key, 0)
    if isinstance(graphs, int):
        if graphs < EAGER_CALLS:
            cache.pairs[key] = graphs + 1
            return _teacher_loop(sp, cfg, enc_out, enc_len, teacher)
        graphs = cache.pairs[key] = SpellerGraphs(
            sp, cfg, enc_out, enc_len, teacher, weights, cache)
        spans.count("las.speller.graph_captures")
    spans.count("las.speller.graph_steps", teacher.shape[1])
    return _Graphed.apply(cache, graphs, enc_out, enc_len, teacher,
                          *weights)


class LAS(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        compute_dtype(cfg)                          # refuse an unknown dtype
        if cfg.enc_type == "cnn":
            self.listener = Listener(cfg)
        elif cfg.enc_type == "pblstm":
            self.listener = PBLSTMListener(cfg)
        else:
            raise ValueError(f"--enc_type must be 'cnn' or 'pblstm', got "
                             f"{cfg.enc_type!r}")
        self.speller = Speller(cfg)

    def forward(self, audio: torch.Tensor, audiolen: torch.Tensor,
                dec_steps: int):
        """Greedy inference in the dtype of the weights the model holds
        (bfloat16 inside compute_cast).  Returns (logits, alphas) in
        float32 and enc_len."""
        audio = audio.to(self.speller.embedding.weight.dtype)
        with spans.span("las.listener"):
            enc_out, enc_len = self.listener(audio, audiolen)
        logits, alphas = speller_greedy(self.speller, enc_out, enc_len,
                                        dec_steps)
        return logits.float(), alphas.float(), enc_len


def las_forward(model: LAS, audio, audiolen, cfg: Config, dec_steps: int,
                teacher: Optional[torch.Tensor] = None,
                is_training: bool = True,
                generator: Optional[torch.Generator] = None,
                tf_rate: Union[float, torch.Tensor] = 1.0,
                rank_generator: Optional[torch.Generator] = None,
                group: distributed.Group = None):
    """Full encoder-decoder forward in cfg's compute dtype.  Returns
    (logits, ctc_logits, alphas, enc_len, new BN state), the first three in
    float32; ctc_logits is None without cfg.ctc.  Training runs the
    teacher's first dec_steps tokens; inference is greedy.  Under data
    parallelism `generator` is the ranks' shared stream, `rank_generator`
    this rank's own (speller_train), and `group` the ranks whose batch BN
    normalizes over."""
    per_row = rank_generator if rank_generator is not None else generator
    with compute_cast(cfg, model):
        with spans.span("las.listener"):
            enc_out, enc_len, lstate = model.listener.encode(
                audio.to(compute_dtype(cfg)), audiolen, is_training,
                cfg.dropout_rate, per_row, group)
        sp = model.speller
        ctc_logits = (sp.ctc_head(enc_out).float()
                      if sp.ctc_head is not None else None)
        if is_training:
            logits, alphas = speller_train(sp, cfg, enc_out, enc_len,
                                           teacher[:, :dec_steps], generator,
                                           tf_rate, per_row)
        else:
            logits, alphas = speller_greedy(sp, enc_out, enc_len, dec_steps)
    state = {f"listener.{k}": v for k, v in lstate.items()}
    return logits.float(), ctc_logits, alphas.float(), enc_len, state


@torch.no_grad()
def assign_bn_state(model: LAS, state: BNState) -> None:
    """Write new BN moving statistics (from las_forward) into the model."""
    for name, (mean, var) in state.items():
        bn = model.get_submodule(name)
        bn.mean.copy_(mean)
        bn.var.copy_(var)


def label_smoothing(one_hot: torch.Tensor, epsilon: float = 0.01
                    ) -> torch.Tensor:
    """(1 - eps) y + eps / K."""
    return (1.0 - epsilon) * one_hot + epsilon / one_hot.shape[-1]


def attention_loss(logits: torch.Tensor, y: torch.Tensor, cfg: Config,
                   group: distributed.Group = None) -> torch.Tensor:
    """Label-smoothed CE averaged over non-PAD positions.  A written-out
    masked sum: cross_entropy(ignore_index=PAD) is NaN on an all-PAD
    batch, this is 0.  With a process group the positions are the global
    batch's: this rank's sum over the group's count, so the ranks' losses
    add up to the global batch's (the average of per-rank means would
    weigh a rank's tokens by its token count)."""
    y = y[:, :logits.shape[1]].long()
    target = F.one_hot(y, cfg.vocab_size).to(logits.dtype)
    if cfg.label_smoothing:
        target = label_smoothing(target)
    ce = -(target * torch.log_softmax(logits, -1)).sum(-1)
    mask = (y != PAD_ID).to(logits.dtype)
    count = mask.sum()
    if group is not None:
        count = distributed.reduced(count, group)
    return (ce * mask).sum() / (count + 1e-9)


def ctc_loss(ctc_logits: torch.Tensor, y: torch.Tensor, enc_len: torch.Tensor,
             cfg: Config, group: distributed.Group = None) -> torch.Tensor:
    """Mean per-utterance CTC NLL over encoder frames, blank = vocab_size,
    labels right-padded with PAD.  With a process group the mean is over
    the global batch's rows: this rank's sum over the group's row count.

    optax.ctc_loss, which the JAX package uses, floors log(0) at
    LOG_EPSILON, so an utterance whose labels need more frames than it has
    (labels + adjacent repeats > enc_len) costs about 1e5 there, where
    F.ctc_loss gives inf and a NaN gradient.  Such rows score
    -LOG_EPSILON here, with no gradient; they go through F.ctc_loss with
    an empty target only so that its backward stays finite.
    cfg.ctc_compat_drop_last drops the batch's last non-PAD label in
    row-major order (the reference's sparse-index off-by-one): with a
    group, the global batch's, which lies on the last rank holding one."""
    T = ctc_logits.shape[1]
    if cfg.ctc_compat_drop_last:
        flat = y.reshape(-1)
        pos = torch.arange(flat.numel(), device=y.device)
        last = torch.where(flat != PAD_ID, pos, -1).max()  # -1: all PAD
        if group is not None:
            rank = torch.distributed.get_rank(group)
            holder = distributed.reduced(
                torch.where(last >= 0, rank, -1), group,
                torch.distributed.ReduceOp.MAX)
            last = torch.where(holder == rank, last, -1)
        y = torch.where(pos == last, PAD_ID, flat).reshape(y.shape)
    y = y.long()
    nonpad = y != PAD_ID
    label_len = nonpad.sum(1)
    repeats = ((y[:, 1:] == y[:, :-1]) & nonpad[:, 1:]).sum(1)
    in_len = enc_len.long().clamp(max=T)
    feasible = label_len + repeats <= in_len
    nll = F.ctc_loss(torch.log_softmax(ctc_logits, -1).transpose(0, 1), y,
                     in_len, torch.where(feasible, label_len, 0),
                     blank=cfg.vocab_size, reduction="none")
    nll = torch.where(feasible, nll, -LOG_EPSILON)
    if group is None:
        return nll.mean()
    rows = distributed.reduced(
        torch.tensor(float(nll.shape[0]), device=nll.device), group)
    return nll.sum() / rows


def total_loss(model: LAS, batch, cfg: Config, dec_steps: int,
               generator: Optional[torch.Generator], step: int,
               rank_generator: Optional[torch.Generator] = None,
               group: distributed.Group = None):
    """Training loss.  Returns (loss, (logits, alphas, new BN state)).
    Under data parallelism (`group`, see las_forward for the generators)
    it is this rank's share of the global batch's loss: the ranks' losses
    sum to it, and so do their gradients."""
    audio, audiolen, y, _ = batch
    per_row = rank_generator if rank_generator is not None else generator
    if cfg.spec_augment:
        # the masks draw from the step's generator, as JAX splits the
        # step key for them; evaluation never masks
        audio = augmentation.spec_augment(per_row, audio, audiolen, cfg)
    tf_rate = (scheduled_sampling_rate(cfg, step)
               if cfg.scheduled_sampling else 1.0)
    logits, ctc_logits, alphas, enc_len, state = las_forward(
        model, audio, audiolen, cfg, dec_steps, teacher=y, is_training=True,
        generator=generator, tf_rate=tf_rate, rank_generator=rank_generator,
        group=group)
    loss = attention_loss(logits, y, cfg, group)
    if cfg.ctc:
        loss = loss + cfg.ctc_weight * ctc_loss(ctc_logits, y, enc_len, cfg,
                                                group)
    return loss, (logits, alphas, state)


def scheduled_learning_rate(cfg: Config, step) -> torch.Tensor:
    """lr, halved every lr_decay_step steps after lr_decay_start, floored
    at lr_min_ratio * lr (float32, as the JAX package computes it)."""
    step = torch.as_tensor(step, dtype=torch.float32)
    decayed = cfg.lr * cfg.lr_decay_rate ** (
        torch.clamp(step - cfg.lr_decay_start, min=0.0) / cfg.lr_decay_step)
    return torch.clamp(decayed, min=cfg.lr_min_ratio * cfg.lr)


def num_params(model: nn.Module) -> int:
    """Trainable parameter count (the JAX pytree's leaf sizes)."""
    return sum(p.numel() for p in model.parameters() if p.requires_grad)


@torch.no_grad()
def init(cfg: Config, generator: torch.Generator,
         device: torch.device) -> LAS:
    """A LAS with the JAX package's init distributions: glorot-uniform
    dense layers and RNN cells (over the fused [x, h] kernel), uniform +-1
    embedding and u, conv N(0, 1) * 0.01 with bias 0.01, location conv
    uniform +-sqrt(6 / (K + K C)), BN scale 1 / bias 0 / mean 0 / var 1,
    biases 0.  `generator` is a CPU generator."""
    model = LAS(cfg)
    g = generator
    for m in model.modules():
        if isinstance(m, nn.Linear):
            L.glorot_uniform_(m.weight, m.in_features, m.out_features, g)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, nn.RNN):
            fan_in, fan_out = m.input_size + m.hidden_size, m.hidden_size
            for name, w in m.named_parameters():
                if name.startswith("weight"):
                    L.glorot_uniform_(w, fan_in, fan_out, g)
                else:
                    w.zero_()           # bias_ih; bias_hh is a zero buffer
        elif isinstance(m, nn.Conv2d):
            m.weight.copy_(torch.randn(m.weight.shape, generator=g) * 0.01)
            m.bias.fill_(0.01)
        elif isinstance(m, nn.Embedding):
            m.weight.uniform_(-1.0, 1.0, generator=g)
    a = model.speller.attention
    a.u.uniform_(-1.0, 1.0, generator=g)
    if a.mode == "loc":
        C, _, K = a.conv_w.shape
        limit = math.sqrt(6.0 / (K + K * C))
        a.conv_w.uniform_(-limit, limit, generator=g)
        a.conv_b.zero_()
    return model.to(device).eval()

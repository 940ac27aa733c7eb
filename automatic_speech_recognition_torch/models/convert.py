"""Carry weights between the JAX package's pytrees and the port's models.

`from_jax_params` takes the nested dicts that
automatic_speech_recognition_tpu.models.las.las_init returns (params and
BN state), with every leaf a NumPy array, and loads them; `to_jax_params`
is its inverse.  `from_jax_lm_params` / `to_jax_lm_params` do the same for
models/char_rnn.lm_init's tree (rnn, lstm and gru cells, one-hot or
embedding input).  Both listeners: 'cnn' (conv{0,1}, bn_conv{0,1},
layer_{i}) and 'pblstm' (birnn0, proj0, pyr_{i}/{birnn, proj}; no BN
state).  Layouts: dense (in, out) <-> Linear (out, in); conv HWIO
<-> OIHW; a BiRNN cell's fused (D + U, U) kernel <-> nn.RNN weight_ih =
w[:D].T, weight_hh = w[D:].T, bias_ih = b (bias_hh is a zero buffer);
location conv (K, 1, C) <-> (C, 1, K).  A missing or extra key, or a wrong
shape, raises.  `per_parameter` maps a tree shaped like the params (an
optax Adam moment or MultiSteps accumulator) through the same layouts, one
array per port parameter (import_checkpoint.py).  `split_dims` is JAX's
tensor-parallel rule (parallel/sharding.param_spec) decided on each JAX
leaf and carried to the port tensors that leaf fills.

The JAX package has no LSTM LAS: a model or Config with rnn_cell 'lstm'
is refused by every conversion of values (from_jax_params,
to_jax_params, per_parameter), never loaded in a tanh cell's layout.
`split_dims` reads shapes alone and takes it: its BiLSTM and speller
kernels are fused (D + U, 4U) leaves, split along the gates.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Tuple, Union

import numpy as np
import torch
from torch import nn

from automatic_speech_recognition_torch.config import Config

from ..ops import layers as L
from ..ops.quant import QuantLinear
from ..parallel.sharding import param_spec
from . import char_rnn, las

_Target = List[Tuple[torch.Tensor, Callable[[np.ndarray], np.ndarray]]]


def _same(a):
    return a


def _t(a):
    return a.T


def _hwio_to_oihw(a):
    return a.transpose(3, 2, 0, 1)


def _oihw_to_hwio(a):
    return a.transpose(2, 3, 1, 0)


def _flip3(a):
    """(K, 1, C) <-> (C, 1, K)."""
    return a.transpose(2, 1, 0)


_INVERSE = {_same: _same, _t: _t, _hwio_to_oihw: _oihw_to_hwio,
            _flip3: _flip3}


def _flatten(tree: Dict, prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(_flatten(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _dense(targets, path: str, m: nn.Linear, w: str = "w",
           b: str = "b") -> None:
    prefix = f"{path}/" if path else ""
    # an int8 QuantLinear's rows stand where the float weight's do: its
    # tree is read for shapes (split_dims), never as values (_leaf)
    targets[prefix + w] = [(m.q if isinstance(m, QuantLinear) else m.weight,
                            _t)]
    if m.bias is not None:
        targets[prefix + b] = [(m.bias, _same)]


def _birnn(targets, path: str, rnn: nn.RNN) -> None:
    D = rnn.input_size
    for d, sfx in (("fw", ""), ("bw", "_reverse")):
        targets[f"{path}/{d}/w"] = [
            (getattr(rnn, f"weight_ih_l0{sfx}"), lambda a: a[:D].T),
            (getattr(rnn, f"weight_hh_l0{sfx}"), lambda a: a[D:].T)]
        targets[f"{path}/{d}/b"] = [(getattr(rnn, f"bias_ih_l0{sfx}"), _same)]


def _refuse_lstm(rnn_cell: str) -> None:
    if rnn_cell != "rnn":
        raise ValueError(
            f"rnn_cell {rnn_cell!r}: the JAX package has no LSTM LAS, so "
            "there is no JAX tree to convert from or to")


def _cell_of(model: las.LAS) -> str:
    return "lstm" if model.speller.lstm else "rnn"


def _leaf(fills: _Target) -> np.ndarray:
    """The JAX leaf rebuilt from the port tensors it fills: a BiRNN
    kernel is the row concat of its two transposed halves; every other
    map is a transpose with a known inverse."""
    if len(fills) == 2:
        (w_ih, _), (w_hh, _) = fills
        return np.concatenate([_np(w_ih).T, _np(w_hh).T], 0)
    (tensor, fn), = fills
    if tensor.dtype == torch.int8:
        raise ValueError("an int8-quantized model has no float JAX tree")
    return _INVERSE[fn](_np(tensor))


def _leaf_shape(fills: _Target) -> Tuple[int, ...]:
    """The shape of the JAX leaf the port tensors fill (_leaf's, without
    reading a value)."""
    if len(fills) == 2:
        (w_ih, _), (w_hh, _) = fills
        return (w_ih.shape[1] + w_hh.shape[1], w_ih.shape[0])
    (tensor, fn), = fills
    return _INVERSE[fn](np.broadcast_to(np.float32(0),
                                        tuple(tensor.shape))).shape


def split_dims(model: Union[las.LAS, char_rnn.CharRNN], model_size: int
               ) -> Dict[str, int]:
    """Port tensor name -> the dim split over a model axis of model_size:
    the tensors of every JAX leaf parallel/sharding.param_spec (the JAX
    package's rule) splits, along the port axis that is the leaf's last.
    That is dim 0 of a Linear, Conv2d, nn.RNN
    (both halves of the BiRNN's fused kernel), location-conv or int8
    weight (whose per-row scale follows it), and dim 1 of an embedding
    table; biases, BN, `u` and conv_b are 1-D and stay whole."""
    targets = (_targets(model) if isinstance(model, las.LAS)
               else _lm_targets(model))
    names = {id(t): n for n, t in list(model.named_parameters())
             + list(model.named_buffers())}
    dims: Dict[str, int] = {}
    for fills in targets.values():
        if param_spec(_leaf_shape(fills), model_size) is None:
            continue
        for tensor, fn in fills:
            name = names[id(tensor)]
            # every layout but the table's (_same) puts the leaf's last
            # axis first
            dims[name] = tensor.dim() - 1 if fn is _same else 0
            if tensor.dtype == torch.int8:
                dims[name.rpartition(".")[0] + ".w_scale"] = 0
    return dims


def _bn(targets, path: str, bn) -> None:
    targets[f"params/{path}/scale"] = [(bn.scale, _same)]
    targets[f"params/{path}/bias"] = [(bn.bias, _same)]
    targets[f"state/{path}/mean"] = [(bn.mean, _same)]
    targets[f"state/{path}/var"] = [(bn.var, _same)]


def _cnn_targets(t: Dict[str, _Target], lis: las.Listener) -> None:
    for i, conv in enumerate((lis.conv0, lis.conv1)):
        t[f"params/listener/conv{i}/w"] = [
            (conv.weight, _hwio_to_oihw)]
        t[f"params/listener/conv{i}/b"] = [(conv.bias, _same)]
    for i, bn in enumerate((lis.bn_conv0, lis.bn_conv1)):
        if bn is not None:
            _bn(t, f"listener/bn_conv{i}", bn)
    for i, layer in enumerate(lis.layers):
        p = f"listener/layer_{i}"
        _birnn(t, f"params/{p}/birnn", layer.birnn)
        _dense(t, f"params/{p}/proj", layer.proj)
        if layer.bn_extra is not None:
            _bn(t, f"{p}/bn_extra", layer.bn_extra)
        _bn(t, f"{p}/bn_main", layer.bn_main)


def _targets(model: las.LAS) -> Dict[str, _Target]:
    """JAX path ('params/...' or 'state/...') -> port tensors to fill."""
    t: Dict[str, _Target] = {}
    lis, sp = model.listener, model.speller
    if isinstance(lis, las.PBLSTMListener):
        _birnn(t, "params/listener/birnn0", lis.birnn0)
        _dense(t, "params/listener/proj0", lis.proj0)
        for i, stage in enumerate(lis.pyr):
            _birnn(t, f"params/listener/pyr_{i}/birnn", stage.birnn)
            _dense(t, f"params/listener/pyr_{i}/proj", stage.proj)
    else:
        _cnn_targets(t, lis)
    t["params/speller/embedding/table"] = [(sp.embedding.weight, _same)]
    a = sp.attention
    for name in ("w_h", "w_s") + (("w_f",) if a.mode == "loc" else ()):
        _dense(t, f"params/speller/attention/{name}", getattr(a, name))
    t["params/speller/attention/u"] = [(a.u, _same)]
    if a.mode == "loc":
        t["params/speller/attention/conv_w"] = [
            (a.conv_w, _flip3)]
        t["params/speller/attention/conv_b"] = [(a.conv_b, _same)]
    _dense(t, "params/speller/out", sp.out)
    for l, cell in enumerate(sp.cells):
        _dense(t, f"params/speller/cell_{l}", cell)
    if sp.ctc_head is not None:
        _dense(t, "params/speller/ctc_head", sp.ctc_head)
    return t


def _arrays(targets: Dict[str, _Target], given: Dict[str, np.ndarray],
            what: str) -> Iterator[Tuple[torch.Tensor, np.ndarray]]:
    """(port tensor, the array it takes) for every target, in the port's
    layout; a missing or extra path, or a wrong shape, raises."""
    missing = sorted(set(targets) - set(given))
    extra = sorted(set(given) - set(targets))
    if missing or extra:
        raise KeyError(f"JAX pytree does not match the port's {what}: "
                       f"missing {missing}, unexpected {extra}")
    for path, fills in targets.items():
        for tensor, fn in fills:
            arr = np.array(fn(given[path]), dtype=np.float32, order="C")
            if arr.shape != tuple(tensor.shape):
                raise ValueError(f"{path}: shape {given[path].shape} maps to "
                                 f"{arr.shape}, expected "
                                 f"{tuple(tensor.shape)}")
            yield tensor, arr


@torch.no_grad()
def _fill(targets: Dict[str, _Target], given: Dict[str, np.ndarray],
          what: str) -> None:
    for tensor, arr in _arrays(targets, given, what):
        tensor.copy_(torch.from_numpy(arr))


def per_parameter(model: Union[las.LAS, char_rnn.CharRNN],
                  arrays: Dict[str, np.ndarray], prefix: str
                  ) -> Dict[torch.Tensor, np.ndarray]:
    """The arrays under `prefix/` of a flat export, shaped like the model's
    JAX params (an Adam moment, a running gradient mean), in the port's
    layout: the array each port parameter takes, keyed by the parameter.
    A missing or extra path, or a wrong shape, raises, naming it."""
    if isinstance(model, las.LAS):
        _refuse_lstm(_cell_of(model))
        targets = {f"{prefix}/{k[len('params/'):]}": v
                   for k, v in _targets(model).items()
                   if k.startswith("params/")}
    else:
        targets = {f"{prefix}/{k}": v for k, v in _lm_targets(model).items()}
    given = {k: v for k, v in arrays.items() if k.startswith(prefix + "/")}
    return dict(_arrays(targets, given, prefix))


def from_jax_params(params_np: Dict, bn_state_np: Dict, cfg: Config,
                    device: torch.device) -> las.LAS:
    """The port's LAS holding the given JAX params and BN state."""
    _refuse_lstm(cfg.rnn_cell)
    model = las.LAS(cfg)
    _fill(_targets(model), {**_flatten(params_np, "params"),
                            **_flatten(bn_state_np, "state")}, "LAS")
    return model.to(device).eval()


def _unflatten(flat: Dict[str, np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, leaf in flat.items():
        node = tree
        *parents, name = path.split("/")
        for k in parents:
            node = node.setdefault(k, {})
        node[name] = leaf
    return tree


def _to_tree(targets: Dict[str, _Target]) -> Dict:
    return _unflatten({
        path: np.ascontiguousarray(_leaf(fills), dtype=np.float32)
        for path, fills in targets.items()})


def to_jax_params(model: las.LAS) -> Tuple[Dict, Dict]:
    """(params, bn_state): the model's weights and BN statistics as the
    JAX package's NumPy pytrees, the inverse of from_jax_params."""
    _refuse_lstm(_cell_of(model))
    tree = _to_tree(_targets(model))
    # a pblstm listener has no BN leaves: its state is {'listener': {}}
    return tree["params"], tree.get("state", {"listener": {}})


def _lm_targets(model: char_rnn.CharRNN) -> Dict[str, _Target]:
    """lm_init's path -> port tensors: embedding/softmax_w/softmax_b, and
    cell_i/{w, b} (rnn, lstm) or cell_i/{wg, bg, wc, bc} (gru)."""
    t: Dict[str, _Target] = {}
    if model.embedding is not None:
        t["embedding"] = [(model.embedding.weight, _same)]
    for i, cell in enumerate(model.cells):
        if isinstance(cell, L.GRUCell):
            _dense(t, f"cell_{i}", cell.gates, "wg", "bg")
            _dense(t, f"cell_{i}", cell.candidate, "wc", "bc")
        else:
            _dense(t, f"cell_{i}", cell)
    _dense(t, "", model.softmax, "softmax_w", "softmax_b")
    return t


def from_jax_lm_params(params_np: Dict, cfg: char_rnn.LMConfig,
                       device: torch.device) -> char_rnn.CharRNN:
    """The port's CharRNN holding the given lm_init-style params."""
    model = char_rnn.CharRNN(cfg)
    _fill(_lm_targets(model), _flatten(params_np), "CharRNN")
    return model.to(device).eval()


def to_jax_lm_params(model: char_rnn.CharRNN) -> Dict:
    """The LM's weights as lm_init's NumPy pytree (from_jax_lm_params's
    inverse)."""
    return _to_tree(_lm_targets(model))

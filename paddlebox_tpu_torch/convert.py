"""Carry dense weights and the dense Adam state between the JAX package and
the port.

JAX models keep params as a dict of arrays; the port's modules register
parameters under the same names (DeepFM: deep_w{i} [din, dout], deep_b{i},
fm_out_w [3], fm_out_b []), so a conversion is a dtype/ownership copy by
name. A nested dict of the JAX params (CtrDnnExpand's ``params["cross"]``:
lin_w, lin_b, fm_scale) is registered flat, its name and the key joined by
an underscore (cross_lin_w, cross_lin_b, cross_fm_scale): params_from_jax
flattens it, params_to_numpy nests the names of ``NESTED_PARAMS`` back.
CtrDnn's data_norm summaries (the JAX params' ``dn_summary`` dict:
batch_size, batch_sum, batch_square_sum) are the module's BUFFERS
dn_summary_*, which the dense optimizer does not see: params_to_numpy reads
them with the parameters, and the Adam state carries zeros at them, as
optax's moments hold zeros where the JAX model's stop_gradient leaves a zero
gradient. CtrDnnAux's side-table rows (the JAX params' ``aux_rows``) are
a buffer of the same kind; JoinPvDnn's ``rank_param`` and every MLP are
parameters by their JAX names.
Host-store rows are numpy f32 in both packages and go across as they are;
so does an f32 slab. A bf16 slab (the slab_embed_dtype diet) is numpy
uint16 [C, device_width] in the reference and the same bits as an int16
tensor in the port (``slab_from_jax`` / ``slab_to_jax``). The dense
optimizer's state crosses as numpy under optax's names: Adam's
``{"mu": {name: array}, "nu": {name: array}, "count": int}``, where the
port's torch.optim.Adam keeps ``exp_avg``, ``exp_avg_sq`` and ``step`` per
parameter (both start at zero with count 0); adagrad's
``{"sum_of_squares": {name: array}}`` (train/dense_optim.py's OptaxAdagrad,
every accumulator starting at ADAGRAD_INITIAL_ACC, 0.1, as optax's does);
sgd's ``{}`` (optax.sgd keeps no state).

A model-parallel tower (models/wide_tower.py) keeps its params outside a
module, a dict of tensors a rank: ``tower_params_from_jax`` slices the
reference's [P, ...] sharded leaves to one rank's, and
``tower_params_to_jax`` stacks the ranks' back. The pipeline's stage
params (parallel/pipeline.py) are stacked [S, ...] in the reference, every
leaf: ``pipeline_params_from_jax`` takes stage s's slice of each (and of
Adam's moments, the count shared), ``pipeline_params_to_jax`` stacks the
stages' back.

The async dense table (train/async_dense.py) keeps the dense state as one
flat f32 vector in the order of ``jax.flatten_util.ravel_pytree`` over the
JAX params dict: keys sorted at every level (a nested dict, ``cross`` or
``dn_summary``, in its place among them), each leaf in C order at its JAX
shape. ``flat_names`` gives the module's tensors in that order,
``flatten_params`` the vector and ``unflatten_params`` writes one back;
the vector carries the buffers (data_norm's summaries, CtrDnnAux's
aux_rows) as the reference's carries those leaves.
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

AdamState = Dict[str, object]

# the nested dicts of the JAX params dicts, by name: their keys
NESTED_PARAMS = {"cross": ("lin_w", "lin_b", "fm_scale"),
                 "dn_summary": ("batch_size", "batch_sum",
                                "batch_square_sum")}


def params_from_jax(params: Mapping[str, object]) -> Dict[str, torch.Tensor]:
    """A JAX params dict (arrays or numpy; a nested dict flattened to
    ``{name}_{key}``) -> a state_dict for ``model.load_state_dict(...,
    strict=True)``."""
    out = {}
    for name, v in params.items():
        if isinstance(v, Mapping):
            out.update(params_from_jax({"%s_%s" % (name, k): x
                                        for k, x in v.items()}))
        else:
            out[name] = torch.from_numpy(np.array(v, dtype=np.float32,
                                                  copy=True))
    return out


def dense_state(model: torch.nn.Module):
    """(name, tensor) of the model's parameters, then of its buffers: the
    JAX params dict's leaves."""
    yield from model.named_parameters()
    yield from model.named_buffers()


def _nest(flat: Mapping[str, object]) -> Dict[str, object]:
    """Flat names -> the JAX params dict's layout: the names of a
    NESTED_PARAMS dict nested under it."""
    out: Dict[str, object] = {}
    for name, a in flat.items():
        for outer, keys in NESTED_PARAMS.items():
            key = name[len(outer) + 1:]
            if name.startswith(outer + "_") and key in keys:
                out.setdefault(outer, {})[key] = a
                break
        else:
            out[name] = a
    return out


def params_to_numpy(model: torch.nn.Module) -> Dict[str, object]:
    """The model's parameters and buffers by JAX name, as float32 numpy
    arrays; the flat names of a NESTED_PARAMS dict nested back under
    it."""
    return _nest({name: p.detach().cpu().numpy().astype(np.float32)
                  for name, p in dense_state(model)})


def flat_names(model: torch.nn.Module) -> List[str]:
    """The names of the model's parameters and buffers in the order
    ravel_pytree flattens the JAX params dict (keys sorted at every level,
    a NESTED_PARAMS dict's keys in its place)."""
    nested = _nest({name: name for name, _ in dense_state(model)})
    out: List[str] = []

    def walk(tree: Mapping) -> None:
        for k in sorted(tree):
            v = tree[k]
            if isinstance(v, Mapping):
                walk(v)
            else:
                out.append(v)

    walk(nested)
    return out


def flatten_params(model: torch.nn.Module) -> np.ndarray:
    """The model's parameters and buffers as one f32 numpy vector in
    ``flat_names`` order: ravel_pytree of the JAX params dict (one copy
    to the host)."""
    tensors = dict(dense_state(model))
    with torch.no_grad():
        flat = torch.cat([tensors[n].detach().reshape(-1).float()
                          for n in flat_names(model)])
    return flat.cpu().numpy()


def unflatten_params(model: torch.nn.Module,
                     flat: Union[np.ndarray, torch.Tensor],
                     names: Optional[Sequence[str]] = None) -> None:
    """Write ``flatten_params``' vector back into the model's tensors, in
    place (one copy to their device); ``names``: only these tensors, the
    others left as they are."""
    tensors = dict(dense_state(model))
    order = flat_names(model)
    sizes = [tensors[n].numel() for n in order]
    if int(np.prod(np.shape(flat))) != sum(sizes):
        raise ValueError("a flat vector of %d values for %d dense values"
                         % (int(np.prod(np.shape(flat))), sum(sizes)))
    first = tensors[order[0]]
    src = torch.as_tensor(flat).to(first.device, torch.float32).reshape(-1)
    want = set(order if names is None else names)
    with torch.no_grad():
        for name, part in zip(order, torch.split(src, sizes)):
            if name in want:
                t = tensors[name]
                t.copy_(part.view(t.shape))


def slab_from_jax(slab) -> torch.Tensor:
    """A reference pass slab (a jax or numpy array: f32 [C, width], or the
    bf16 diet's uint16 [C, device_width]) -> the port's slab on the CPU,
    f32 or the same bits as int16; a copy, bit for bit."""
    a = np.asarray(slab)
    if a.dtype == np.uint16:
        return torch.from_numpy(a.view(np.int16).copy())
    if a.dtype != np.float32:
        raise TypeError("a pass slab is float32 or uint16, got %s" % a.dtype)
    return torch.from_numpy(a.copy())


def slab_to_jax(slab: torch.Tensor) -> np.ndarray:
    """The port's slab (f32, or int16 bf16 diet rows, on any device) -> the
    reference's numpy form: f32, or the same bits as uint16."""
    a = slab.detach().cpu().numpy()
    if a.dtype == np.int16:
        return a.view(np.uint16)
    if a.dtype != np.float32:
        raise TypeError("a pass slab is float32 or int16, got %s" % a.dtype)
    return a


def adam_state_to_numpy(model: torch.nn.Module,
                        opt: torch.optim.Optimizer) -> AdamState:
    """The Adam state of ``model``'s parameters under optax's names, as
    numpy: zeros and count 0 before the first step, as optax.adam's init
    gives them; zeros at the buffers (nested as params_to_numpy nests
    them)."""
    mu, nu, count = {}, {}, 0
    for name, p in model.named_parameters():
        st = opt.state.get(p)
        if st:
            mu[name] = st["exp_avg"].detach().cpu().numpy().copy()
            nu[name] = st["exp_avg_sq"].detach().cpu().numpy().copy()
            count = int(st["step"])
        else:
            mu[name] = np.zeros(tuple(p.shape), np.float32)
            nu[name] = np.zeros(tuple(p.shape), np.float32)
    for m in (mu, nu):
        m.update(_nest({name: np.zeros(tuple(b.shape), np.float32)
                        for name, b in model.named_buffers()}))
    return {"mu": mu, "nu": nu, "count": count}


def adam_state_from_numpy(model: torch.nn.Module, opt: torch.optim.Optimizer,
                          state: Mapping) -> None:
    """Set ``opt``'s Adam state from ``adam_state_to_numpy``'s form, bit
    for bit; count 0 leaves the optimizer as a fresh one. The moments at
    buffers (zeros) are not read."""
    opt.state.clear()
    count = int(state["count"])
    if count == 0:
        return
    for name, p in model.named_parameters():
        opt.state[p] = {
            "step": torch.tensor(float(count), dtype=torch.float32),
            "exp_avg": torch.from_numpy(np.array(
                state["mu"][name], np.float32)).to(p.device),
            "exp_avg_sq": torch.from_numpy(np.array(
                state["nu"][name], np.float32)).to(p.device)}


def _leaf_paths(tree: Mapping, prefix=()) -> list:
    """(key path, shape) of each array leaf of a nested params dict, in
    the order jax.tree flattens it (keys sorted at every level)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            out.extend(_leaf_paths(v, prefix + (k,)))
        else:
            out.append((prefix + (k,), np.shape(v)))
    return out


# optax.adagrad's defaults, which the reference's optax.adagrad(lr) takes
# (train/dense_optim.py OptaxAdagrad): the accumulator's initial value and
# the eps inside the root
ADAGRAD_INITIAL_ACC = 0.1
ADAGRAD_EPS = 1e-7


def adagrad_state_to_numpy(model: torch.nn.Module,
                           opt: torch.optim.Optimizer) -> AdamState:
    """The adagrad accumulators of ``model``'s parameters under optax's
    name, as numpy; the buffers at ADAGRAD_INITIAL_ACC (their gradient is
    zero, so optax's accumulator never moves there), nested as
    params_to_numpy nests them."""
    acc = {name: opt.state[p]["sum_of_squares"].detach().cpu().numpy().copy()
           for name, p in model.named_parameters()}
    acc.update(_nest({name: np.full(tuple(b.shape), ADAGRAD_INITIAL_ACC,
                                    np.float32)
                      for name, b in model.named_buffers()}))
    return {"sum_of_squares": acc}


def adagrad_state_from_numpy(model: torch.nn.Module,
                             opt: torch.optim.Optimizer,
                             state: Mapping) -> None:
    """Set ``opt``'s accumulators from ``adagrad_state_to_numpy``'s form,
    bit for bit (the entries at buffers are not read)."""
    acc = state["sum_of_squares"]
    for name, p in model.named_parameters():
        opt.state[p]["sum_of_squares"].copy_(torch.from_numpy(
            np.array(acc[name], np.float32)))


def _optax_tree(tree, leaves) -> Dict[str, object]:
    """A per-parameter optax tree (nested dicts, or one vector under
    optax.flatten, raveled in jax.tree order) -> numpy arrays nested as
    the params are, for the (path, shape) ``leaves``."""
    out: Dict[str, object] = {}
    at = 0
    flat = None if isinstance(tree, Mapping) else np.asarray(tree,
                                                             np.float32)
    for path, shape in leaves:
        if flat is None:
            v = tree
            for k in path:
                v = v[k]
            a = np.asarray(v, np.float32).copy()
        else:
            size = int(np.prod(shape, dtype=np.int64))
            a = flat[at:at + size].reshape(shape).copy()
            at += size
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = a
    if flat is not None and at != flat.size:
        raise ValueError("flat optimizer state of %d values for %d "
                         "parameters" % (flat.size, at))
    return out


def adagrad_state_from_optax(opt_state, params: Mapping[str, object]
                             ) -> AdamState:
    """An optax.adagrad state (a tuple holding a state with
    ``sum_of_squares``, per parameter or flattened) ->
    ``adagrad_state_to_numpy``'s form."""
    rss = next(s for s in opt_state if hasattr(s, "sum_of_squares"))
    return {"sum_of_squares": _optax_tree(rss.sum_of_squares,
                                          _leaf_paths(params))}


def adam_state_from_optax(opt_state, params: Mapping[str, object]
                          ) -> AdamState:
    """An optax.adam state (a tuple holding a state with ``count``, ``mu``
    and ``nu``; per-parameter dicts, or one vector under optax.flatten,
    raveled in jax.tree order) -> ``adam_state_to_numpy``'s form, for
    the parameters ``params`` names (nested dicts stay nested)."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    leaves = _leaf_paths(params)
    return {"mu": _optax_tree(adam.mu, leaves),
            "nu": _optax_tree(adam.nu, leaves),
            "count": int(np.asarray(adam.count))}


def tower_params_from_jax(host_params: Mapping[str, object],
                          sharded: Mapping[str, bool],
                          rank: int) -> Dict[str, torch.Tensor]:
    """A model-parallel tower's reference params (models/wide_tower.py
    ``host_init``: each sharded leaf stacks the shards on a leading [P]
    axis) and its ``sharded`` mask -> rank ``rank``'s local tensors: a
    sharded leaf's slice [rank], a replicated leaf whole; f32 copies on
    the CPU."""
    return {k: torch.from_numpy(np.array(
        np.asarray(v)[rank] if sharded[k] else v, dtype=np.float32,
        copy=True)) for k, v in host_params.items()}


def tower_params_to_jax(rank_params: Sequence[Mapping[str, object]],
                        sharded: Mapping[str, bool]
                        ) -> Dict[str, np.ndarray]:
    """The inverse of ``tower_params_from_jax`` over every rank: the ranks'
    local leaves (tensors or numpy, in rank order) -> the reference's
    layout, a sharded leaf stacked [P, ...], a replicated leaf rank 0's
    (every rank holds the same)."""
    def host(v) -> np.ndarray:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float32)

    return {k: (np.stack([host(p[k]) for p in rank_params]) if sharded[k]
                else host(rank_params[0][k])) for k in sharded}


def pipeline_params_from_jax(params: Mapping[str, object], stage: int,
                             opt_state=None):
    """The pipeline's stacked [S, ...] reference params -> (stage
    ``stage``'s tensors, its Adam state or None): f32 copies on the CPU of
    each leaf's slice [stage]. ``opt_state``: optax.adam's state over
    ``params`` or ``adam_state_from_optax``'s form of it; the state comes
    back as {"mu": {name: tensor}, "nu": {...}, "count": int}, the moments
    sliced as the params."""
    def cut(v) -> torch.Tensor:
        return torch.from_numpy(np.array(np.asarray(v)[stage],
                                         dtype=np.float32, copy=True))

    tensors = {k: cut(v) for k, v in params.items()}
    if opt_state is None:
        return tensors, None
    if not (isinstance(opt_state, Mapping) and "mu" in opt_state):
        opt_state = adam_state_from_optax(opt_state, params)
    return tensors, {"mu": {k: cut(v) for k, v in opt_state["mu"].items()},
                     "nu": {k: cut(v) for k, v in opt_state["nu"].items()},
                     "count": int(opt_state["count"])}


def pipeline_params_to_jax(stage_params: Sequence[Mapping[str, object]]
                           ) -> Dict[str, np.ndarray]:
    """The inverse of ``pipeline_params_from_jax`` over every stage: the
    stages' tensors (or numpy, in stage order) -> the reference's stacked
    [S, ...] leaves."""
    def host(v) -> np.ndarray:
        if isinstance(v, torch.Tensor):
            v = v.detach().cpu().numpy()
        return np.asarray(v, dtype=np.float32)

    return {k: np.stack([host(p[k]) for p in stage_params])
            for k in stage_params[0]}

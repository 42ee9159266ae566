"""Carry dense weights and the dense Adam state between the JAX package and
the port.

JAX models keep params as a dict of arrays; the port's modules register
parameters under the same names (DeepFM: deep_w{i} [din, dout], deep_b{i},
fm_out_w [3], fm_out_b []), so a conversion is a dtype/ownership copy by
name. A nested dict of the JAX params (CtrDnnExpand's ``params["cross"]``:
lin_w, lin_b, fm_scale) is registered flat, its name and the key joined by
an underscore (cross_lin_w, cross_lin_b, cross_fm_scale): params_from_jax
flattens it, params_to_numpy nests the names of ``NESTED_PARAMS`` back.
Host-store rows are numpy f32 in both packages and go across as they are;
so does an f32 slab. A bf16 slab (the slab_embed_dtype diet) is numpy
uint16 [C, device_width] in the reference and the same bits as an int16
tensor in the port (``slab_from_jax`` / ``slab_to_jax``). The dense Adam
state crosses as numpy under optax's names:
``{"mu": {name: array}, "nu": {name: array}, "count": int}``, where the
port's torch.optim.Adam keeps ``exp_avg``, ``exp_avg_sq`` and ``step`` per
parameter; both start at zero with count 0.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

AdamState = Dict[str, object]

# the nested dicts of the JAX params dicts, by name: their keys
NESTED_PARAMS = {"cross": ("lin_w", "lin_b", "fm_scale")}


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


def params_to_numpy(model: torch.nn.Module) -> Dict[str, object]:
    """The model's parameters by JAX name, as float32 numpy arrays; the
    flat names of a NESTED_PARAMS dict nested back under it."""
    out: Dict[str, object] = {}
    for name, p in model.named_parameters():
        a = p.detach().cpu().numpy().astype(np.float32)
        for outer, keys in NESTED_PARAMS.items():
            key = name[len(outer) + 1:]
            if name.startswith(outer + "_") and key in keys:
                out.setdefault(outer, {})[key] = a
                break
        else:
            out[name] = a
    return out


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
    gives them."""
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
    return {"mu": mu, "nu": nu, "count": count}


def adam_state_from_numpy(model: torch.nn.Module, opt: torch.optim.Optimizer,
                          state: Mapping) -> None:
    """Set ``opt``'s Adam state from ``adam_state_to_numpy``'s form, bit
    for bit; count 0 leaves the optimizer as a fresh one."""
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


def adam_state_from_optax(opt_state, params: Mapping[str, np.ndarray]
                          ) -> AdamState:
    """An optax.adam state (a tuple holding a state with ``count``, ``mu``
    and ``nu``; per-parameter dicts, or one vector under optax.flatten,
    raveled in sorted-name order) -> ``adam_state_to_numpy``'s form, for
    the parameters ``params`` names."""
    adam = next(s for s in opt_state if hasattr(s, "mu"))
    shapes = {k: np.shape(v) for k, v in params.items()}

    def split(tree) -> Dict[str, np.ndarray]:
        if isinstance(tree, Mapping):
            return {k: np.asarray(tree[k], np.float32).copy()
                    for k in shapes}
        flat = np.asarray(tree, np.float32)
        out, at = {}, 0
        for k in sorted(shapes):
            size = int(np.prod(shapes[k], dtype=np.int64))
            out[k] = flat[at:at + size].reshape(shapes[k]).copy()
            at += size
        if at != flat.size:
            raise ValueError("flat Adam state of %d values for %d "
                             "parameters" % (flat.size, at))
        return out

    return {"mu": split(adam.mu), "nu": split(adam.nu),
            "count": int(np.asarray(adam.count))}

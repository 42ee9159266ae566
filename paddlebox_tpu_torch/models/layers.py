"""MLP parameters and application (paddlebox_tpu/models/layers.py:19-53).

Weights are [din, dout] (``x @ w + b``) and named ``{name}_w{i}`` /
``{name}_b{i}``, the JAX layout, so a JAX params dict loads by name.

``matmul_dtype="bfloat16"`` (DtypeFlags.matmul_dtype) is JAX's
dot_general of bf16 operands with preferred_element_type=f32: the operands
rounded to bf16, their products summed in f32, an f32 result. A bf16
torch.matmul rounds its output to bf16, another function; so the port
multiplies the rounded operands upcast to f32, where each product of two
8-bit significands is exact, on the CPU and on the card alike (a bf16 GEMM
with an f32 output is not a stable public op of the installed torch).
Mixed operand dtypes promote as jnp's ``@`` promotes them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Sequence

import torch
from torch import nn


def mlp_init(module: nn.Module, dims: Sequence[int], name: str,
             generator: Optional[torch.Generator] = None) -> None:
    """Register He-normal weights and zero biases on ``module``:
    dims = [in, h1, ..., out]."""
    for i, (din, dout) in enumerate(zip(dims[:-1], dims[1:])):
        w = torch.randn(din, dout, generator=generator) * math.sqrt(2.0 / din)
        module.register_parameter(f"{name}_w{i}", nn.Parameter(w))
        module.register_parameter(f"{name}_b{i}",
                                  nn.Parameter(torch.zeros(dout)))


def promoted_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w in the promoted dtype of the two (jnp's ``@``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return torch.matmul(x.to(dt), w.to(dt))


def matmul(x: torch.Tensor, w: torch.Tensor,
           matmul_dtype: str = "float32") -> torch.Tensor:
    """The dense layer's product under ``matmul_dtype`` (layers.matmul)."""
    if matmul_dtype == "bfloat16":
        return torch.matmul(x.to(torch.bfloat16).float(),
                            w.to(torch.bfloat16).float())
    return promoted_matmul(x, w)


def mlp_apply(module: nn.Module, x: torch.Tensor, name: str,
              act: Callable = torch.relu,
              matmul_dtype: str = "float32",
              final_act: bool = False) -> torch.Tensor:
    """Dense layers in order, ``act`` between them, and after the last one
    too with ``final_act``."""
    i = 0
    while hasattr(module, f"{name}_w{i}"):
        x = matmul(x, getattr(module, f"{name}_w{i}"), matmul_dtype) \
            + getattr(module, f"{name}_b{i}")
        if final_act or hasattr(module, f"{name}_w{i + 1}"):
            x = act(x)
        i += 1
    return x


def with_dense(x: torch.Tensor, dense: Optional[torch.Tensor]
               ) -> torch.Tensor:
    """x [B, F] with the dense columns appended, when there are any (in
    the promoted dtype, as jnp.concatenate gives it)."""
    if dense is None:
        return x
    return torch.cat([x, dense], dim=-1)

"""Argument checks and routing shared by every kernel wrapper of the port
(embedding/push_kernels.py, ops/row_kernels.py).

A wrapper checks each tensor with ``check``, asks ``use_kernel`` whether to
launch (CUDA tensors) or run its plain version (CPU tensors only), and
passes the C entry's return code, ``cudaGetLastError()`` after the launch,
to ``raise_on``.
"""

from __future__ import annotations

import torch


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int,
          device: torch.device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError("%s must be a tensor" % name)
    if t.dtype != dtype:
        raise TypeError("%s must be %s, got %s" % (name, dtype, t.dtype))
    if t.dim() != ndim:
        raise ValueError("%s must have %d dims, got shape %s"
                         % (name, ndim, tuple(t.shape)))
    if not t.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if t.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, t.device, device))


def use_kernel(device: torch.device) -> bool:
    """True: launch the CUDA kernel; False: the plain version (CPU only)."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError("the port's kernels run on cuda or cpu tensors, got %s"
                     % device)


def raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError("%s kernel launch failed: CUDA error %d"
                           % (what, rc))

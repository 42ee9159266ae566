"""The rate probe's two kernels: wrappers, plain versions, launch counts.

  scale_copy   <- tools/pallas_rate_probe.py:copy_kernel (pallas_scale),
                  source csrc/scale_copy.cu
  gather_rows  <- tools/pallas_rate_probe.py:gather_kernel (pgather),
                  source csrc/gather_rows.cu; also the train step's pull
                  (ops/sparse.py:gather_slab_rows), and the pass table's
                  delta promote and touched-row write-back
                  (embedding/pass_table.py)

Each wrapper checks dtype, shape, contiguity and device, then:
  * on CPU tensors runs its ``*_plain`` PyTorch version;
  * on CUDA tensors launches its kernel on the current stream, raises if
    the launch reports an error, and adds one to ``<wrapper>.launches``.
There is no fallback from the card to the plain version. The plain
versions stay callable on the card, where chip_smoke.py holds each kernel
against them.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from paddlebox_tpu_torch.native.kernel_args import (check, raise_on,
                                                    use_kernel)

# the probe's constants as f32, the type its kernel computes in
SCALE = float(np.float32(0.999))
SHIFT = float(np.float32(0.001))


# ------------------------------------------------------------- scale_copy

def scale_copy(x: torch.Tensor) -> torch.Tensor:
    """x * 0.999 + 0.001 rounded once to f32 (a fused multiply-add, as the
    Pallas kernel gives when interpreted on XLA:CPU), for a contiguous f32
    ``x`` [n, W]. Returns a new tensor."""
    dev = x.device
    check(x, "x", torch.float32, 2, dev)
    if not use_kernel(dev):
        return scale_copy_plain(x)
    from paddlebox_tpu_torch.native.build import load_kernel
    lib = load_kernel("scale_copy")
    out = torch.empty_like(x)
    if x.numel():
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.pbt_scale_copy(x.data_ptr(), out.data_ptr(), x.numel(),
                                    stream)
        raise_on(rc, "scale_copy")
        scale_copy.launches += 1
    return out


scale_copy.launches = 0


def scale_copy_plain(x: torch.Tensor) -> torch.Tensor:
    """The kernel's function in PyTorch ops. The f32 x f32 product is exact
    in f64; the f64 add rounds, and the cast to f32 rounds again. The two
    roundings give the fused multiply-add's one rounding unless the f64 sum
    lands exactly on a tie between two f32 values.
    tests/test_torch_row_kernels.py holds this version against an exact
    emulation over a sample of every f32 binade and finds no such x for
    these two constants."""
    return (x.double() * SCALE + SHIFT).float()


# ------------------------------------------------------------ gather_rows

def gather_rows(src: torch.Tensor, ids: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[K, W] rows src[min(ids, C - 1)] for src [C, W] f32 and ids [K]
    int32 >= 0 (an id of C or more reads the last row, as JAX's gather
    clamps). Returns a new tensor, or fills ``out`` (contiguous f32 [K, W]
    on src's device, in storage of its own) and returns it."""
    dev = src.device
    check(src, "src", torch.float32, 2, dev)
    check(ids, "ids", torch.int32, 1, dev)
    C, W = src.shape
    K = ids.shape[0]
    if K and not C:
        raise ValueError("gather_rows from an empty source of %d ids" % K)
    if out is not None:
        check(out, "out", torch.float32, 2, dev)
        if tuple(out.shape) != (K, W):
            raise ValueError("out must be %s, got %s"
                             % ((K, W), tuple(out.shape)))
        if out.untyped_storage().data_ptr() == \
                src.untyped_storage().data_ptr():
            raise ValueError("gather_rows: out shares its storage with src")
    if not use_kernel(dev):
        return gather_rows_plain(src, ids, out)
    from paddlebox_tpu_torch.native.build import load_kernel
    lib = load_kernel("gather_rows")
    if out is None:
        out = torch.empty((K, W), dtype=src.dtype, device=dev)
    if K and W:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.pbt_gather_rows(src.data_ptr(), ids.data_ptr(),
                                     out.data_ptr(), C, K, W, stream)
        raise_on(rc, "gather_rows")
        gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_rows_plain(src: torch.Tensor, ids: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: clamp, then index_select
    (into ``out`` when given)."""
    return torch.index_select(src, 0, ids.clamp(max=src.shape[0] - 1),
                              out=out)


def launch_counts() -> dict:
    """Launch counts of both kernels, by kernel name."""
    return {"scale_copy": scale_copy.launches,
            "gather_rows": gather_rows.launches}


def reset_launch_counts() -> None:
    scale_copy.launches = 0
    gather_rows.launches = 0

"""The rate probe's two kernels: wrappers, plain versions, launch counts.

  scale_copy   <- tools/pallas_rate_probe.py:copy_kernel (pallas_scale),
                  source csrc/scale_copy.cu
  gather_rows  <- tools/pallas_rate_probe.py:gather_kernel (pgather),
                  source csrc/gather_rows.cu; also the train step's pull
                  (ops/sparse.py:gather_slab_rows), and the pass table's
                  delta promote and touched-row write-back
                  (embedding/pass_table.py). It takes an f32 source or
                  the bf16 slab's int16 bits (its 2-byte form, counted
                  apart as ``launches_2byte``)
  gather_rows_decode  the 2-byte gather with the slab codec's decode
                  fused, f32 rows out (the same source; the pull of a
                  bf16 slab)

Each wrapper checks dtype, shape, contiguity and device, then:
  * on CPU tensors runs its ``*_plain`` PyTorch version;
  * on CUDA tensors launches its kernel on the current stream, raises if
    the launch reports an error, and adds one to ``<wrapper>.launches``.
There is no fallback from the card to the plain version. The plain
versions stay callable on the card, where chip_smoke.py holds each kernel
against them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from paddlebox_tpu_torch.embedding.accessor import (ValueLayout,
                                                    decode_slab_rows,
                                                    slab_codec_columns)
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

def _check_gather(src: torch.Tensor, ids: torch.Tensor) -> None:
    dev = src.device
    if src.dtype not in (torch.float32, torch.int16):
        raise TypeError("src must be torch.float32 or torch.int16, got %s"
                        % src.dtype)
    check(src, "src", src.dtype, 2, dev)
    check(ids, "ids", torch.int32, 1, dev)
    if ids.shape[0] and not src.shape[0]:
        raise ValueError("gather_rows from an empty source of %d ids"
                         % ids.shape[0])


def gather_rows(src: torch.Tensor, ids: torch.Tensor,
                out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[K, W] rows src[min(ids, C - 1)] for src [C, W] f32, or int16 (the
    bf16 slab's bits, moved as they are), and ids [K] int32 >= 0 (an id
    of C or more reads the last row, as JAX's gather clamps). Returns a
    new tensor, or fills ``out`` (contiguous [K, W] of src's dtype on its
    device, in storage of its own) and returns it."""
    _check_gather(src, ids)
    dev = src.device
    C, W = src.shape
    K = ids.shape[0]
    if out is not None:
        check(out, "out", src.dtype, 2, dev)
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
        two = src.dtype == torch.int16
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            fn = lib.pbt_gather_rows_2byte if two else lib.pbt_gather_rows
            rc = fn(src.data_ptr(), ids.data_ptr(), out.data_ptr(), C, K, W,
                    stream)
        raise_on(rc, "gather_rows")
        if two:
            gather_rows.launches_2byte += 1
        else:
            gather_rows.launches += 1
    return out


gather_rows.launches = 0
gather_rows.launches_2byte = 0


def gather_rows_plain(src: torch.Tensor, ids: torch.Tensor,
                      out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The kernel's function in PyTorch ops: clamp, then index_select
    (into ``out`` when given)."""
    return torch.index_select(src, 0, ids.clamp(max=src.shape[0] - 1),
                              out=out)


def gather_rows_decode(src: torch.Tensor, ids: torch.Tensor,
                       layout: ValueLayout) -> torch.Tensor:
    """[K, layout.width] f32 rows decode_slab_rows(src[min(ids, C - 1)])
    for the bf16 slab ``src`` [C, layout.device_width] int16 and ids [K]
    int32 >= 0: the 2-byte gather with the codec's decode fused into its
    output."""
    _check_gather(src, ids)
    if not layout.bf16 or src.dtype != torch.int16 or \
            src.shape[1] != layout.device_width:
        raise ValueError("gather_rows_decode takes a bf16 layout's int16 "
                         "slab of %d columns, got %s %s"
                         % (layout.device_width, src.dtype,
                            tuple(src.shape)))
    dev = src.device
    if not use_kernel(dev):
        return gather_rows_decode_plain(src, ids, layout)
    from paddlebox_tpu_torch.native.build import load_kernel
    lib = load_kernel("gather_rows")
    C, W = src.shape
    K, WL = ids.shape[0], layout.width
    out = torch.empty((K, WL), dtype=torch.float32, device=dev)
    if K:
        cols = (ctypes.c_int * (2 * WL))(*slab_codec_columns(layout))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.pbt_gather_rows_decode(src.data_ptr(), ids.data_ptr(),
                                            out.data_ptr(), C, K, W, WL,
                                            cols, stream)
        raise_on(rc, "gather_rows_decode")
        gather_rows_decode.launches += 1
    return out


gather_rows_decode.launches = 0


def gather_rows_decode_plain(src: torch.Tensor, ids: torch.Tensor,
                             layout: ValueLayout) -> torch.Tensor:
    """The decoding gather's function in PyTorch ops: the plain gather,
    then the codec's decode."""
    return decode_slab_rows(gather_rows_plain(src, ids), layout)


def launch_counts() -> dict:
    """Launch counts of the kernels, by kernel form: each copy kernel on
    f32 rows, the 2-byte gather, and the decoding gather."""
    return {"scale_copy": scale_copy.launches,
            "gather_rows": gather_rows.launches,
            "gather_rows_2byte": gather_rows.launches_2byte,
            "gather_rows_decode": gather_rows_decode.launches}


def reset_launch_counts() -> None:
    scale_copy.launches = 0
    gather_rows.launches = 0
    gather_rows.launches_2byte = 0
    gather_rows_decode.launches = 0

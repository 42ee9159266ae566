"""The sparse push's two kernels: wrappers, plain versions, launch counts.

  push_adagrad   <- paddlebox_tpu/embedding/pallas_push.py:_push_kernel
                    (pallas_apply_push), source csrc/push_adagrad.cu
  blocked_write  <- paddlebox_tpu/embedding/pallas_push.py:
                    _blocked_write_kernel (pallas_blocked_write), source
                    csrc/blocked_write.cu

Each wrapper checks dtype, shape, contiguity and device, then:
  * on CPU tensors runs its ``*_plain`` PyTorch version (that is what the
    CPU tests exercise);
  * on CUDA tensors launches its kernel on the current stream, raises if
    the launch reports an error, and adds one to ``<wrapper>.launches``.
There is no fallback from the card to the plain version: a CUDA tensor
either goes through the kernel or the call raises. The plain versions stay
callable on the card, where chip_smoke.py holds each kernel against them.
"""

from __future__ import annotations

import ctypes

import torch

from paddlebox_tpu_torch.config.configs import SparseOptimizerConfig
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
from paddlebox_tpu_torch.native.kernel_args import (check, raise_on,
                                                    use_kernel)


# ------------------------------------------------------------ push_adagrad

def _conf_floats(conf: SparseOptimizerConfig):
    """PushConf order of csrc/push_adagrad.cu."""
    return (conf.nonclk_coeff, conf.clk_coeff, float(conf.nodeid_slot),
            conf.mf_learning_rate, conf.feature_learning_rate,
            conf.mf_initial_g2sum, conf.mf_min_bound, conf.mf_max_bound,
            conf.mf_create_thresholds, conf.mf_initial_range)


def push_adagrad(values: torch.Tensor, grads: torch.Tensor,
                 row_ids: torch.Tensor, seed: int, layout: ValueLayout,
                 conf: SparseOptimizerConfig) -> torch.Tensor:
    """Updated rows [U, width] for value rows ``values`` [U, width] f32,
    merged push grads ``grads`` [U, 4+D] f32 and slab ids ``row_ids`` [U]
    int32 (they key the creation randoms); ``seed`` is a nonnegative int32.
    Returns a new tensor; the inputs are not modified."""
    if layout.optimizer != "adagrad":
        raise ValueError("push_adagrad supports the adagrad layout only")
    dev = values.device
    U = values.shape[0] if values.dim() == 2 else -1
    check(values, "values", torch.float32, 2, dev)
    check(grads, "grads", torch.float32, 2, dev)
    check(row_ids, "row_ids", torch.int32, 1, dev)
    if values.shape[1] != layout.width:
        raise ValueError("values width %d != layout width %d"
                         % (values.shape[1], layout.width))
    if grads.shape != (U, PushLayout(layout.embedx_dim).width):
        raise ValueError("grads shape %s != (%d, %d)" % (
            tuple(grads.shape), U, PushLayout(layout.embedx_dim).width))
    if row_ids.shape[0] != U:
        raise ValueError("row_ids length %d != rows %d"
                         % (row_ids.shape[0], U))
    if not 0 <= int(seed) < 2**31:
        raise ValueError("seed must be a nonnegative int32, got %r" % seed)
    if not use_kernel(dev):
        return push_adagrad_plain(values, grads, row_ids, seed, layout, conf)
    from paddlebox_tpu_torch.native.build import load_kernel
    lib = load_kernel("push_adagrad")
    out = torch.empty_like(values)
    if U:
        cf = (ctypes.c_float * 10)(*_conf_floats(conf))
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.pbt_push_adagrad(
                values.data_ptr(), grads.data_ptr(), row_ids.data_ptr(),
                out.data_ptr(), U, layout.embedx_dim, int(seed), cf, stream)
        raise_on(rc, "push_adagrad")
        push_adagrad.launches += 1
    return out


push_adagrad.launches = 0


def push_adagrad_plain(values: torch.Tensor, grads: torch.Tensor,
                       row_ids: torch.Tensor, seed: int, layout: ValueLayout,
                       conf: SparseOptimizerConfig) -> torch.Tensor:
    """The kernel's function in PyTorch ops, in the kernel's f32 operation
    order (the mean of the D squared embedx grads summed from column 0 up),
    so on the card the two agree bit for bit."""
    D = layout.embedx_dim
    push = PushLayout(D)
    dev = values.device

    def f(x: float) -> torch.Tensor:
        return torch.tensor(x, dtype=torch.float32, device=dev)

    nonclk, clk = f(conf.nonclk_coeff), f(conf.clk_coeff)
    ig2 = f(conf.mf_initial_g2sum)
    lo, hi = f(conf.mf_min_bound), f(conf.mf_max_bound)
    g_show = grads[:, push.SHOW]
    g_click = grads[:, push.CLICK]
    active = g_show > 0
    scale = torch.where(active, g_show, torch.ones_like(g_show))
    slot = torch.where(active, grads[:, push.SLOT], values[:, acc.SLOT])
    show = values[:, acc.SHOW] + g_show
    click = values[:, acc.CLICK] + g_click
    delta = (values[:, acc.DELTA_SCORE] + nonclk * (g_show - g_click)
             + clk * g_click)
    unseen = torch.zeros_like(g_show)

    lr = torch.where(slot == float(conf.nodeid_slot),
                     f(conf.mf_learning_rate), f(conf.feature_learning_rate))
    g2 = values[:, layout.embed_state]
    sw = grads[:, push.EMBED_G] / scale
    ratio = lr * torch.sqrt(ig2 / (ig2 + g2))
    neww = torch.clamp(values[:, acc.EMBED_W] + ratio * sw, lo, hi)
    newg2 = g2 + sw * sw

    xw = layout.embedx_w
    x = values[:, xw:xw + D]
    xg2 = values[:, layout.embedx_state]
    sx = grads[:, push.embedx_g:push.embedx_g + D] / scale[:, None]
    sq = torch.zeros_like(xg2)
    for c in range(D):
        sq = sq + sx[:, c] * sx[:, c]
    xratio = f(conf.mf_learning_rate) * torch.sqrt(ig2 / (ig2 + xg2))
    newx = torch.clamp(x + xratio[:, None] * sx, lo, hi)
    newxg2 = xg2 + sq / f(float(D))

    mf_size = values[:, acc.MF_SIZE]
    score = nonclk * (show - click) + clk * click
    create = (mf_size == 0) & (score >= f(conf.mf_create_thresholds)) \
        & active
    has_mf = (mf_size > 0) & active
    mask32 = 0xFFFFFFFF
    r = row_ids.to(torch.int64) & mask32
    cols = torch.arange(D, dtype=torch.int64, device=dev)
    bits = ((r[:, None] * 2654435761) & mask32) ^ (
        (cols[None, :] * 40503 + (int(seed) & mask32)) & mask32)
    bits = (bits * 747796405 + 2891336453) & mask32
    bits = bits ^ (bits >> 16)
    u01 = (bits >> 8).to(torch.int32).to(torch.float32) * f(1.0 / (1 << 24))
    fresh = u01 * f(conf.mf_initial_range)

    out_x = torch.where(create[:, None], fresh,
                        torch.where(has_mf[:, None], newx, x))
    out_xg2 = torch.where(has_mf, newxg2, xg2)
    out_mf = torch.where(create, f(float(D)), mf_size)
    out = torch.cat([
        torch.stack([slot, show, click, delta, unseen, out_mf, neww, newg2],
                    dim=1),
        out_x, out_xg2[:, None]], dim=1)
    return torch.where(active[:, None], out, values)


# ------------------------------------------------------------ blocked_write

def blocked_write(slab: torch.Tensor, new_rows: torch.Tensor,
                  row_map: torch.Tensor, blk_idx: torch.Tensor) -> None:
    """IN PLACE: for each slot i and lane r with row_map[i, r] >= 0,
    slab[blk_idx[i] * B + r] = new_rows[row_map[i, r]]. slab [C, W] f32,
    new_rows [U, W] f32, row_map [NB, B] int32 (values < U), blk_idx [NB]
    int32 block ids in [0, C // B)."""
    dev = slab.device
    check(slab, "slab", torch.float32, 2, dev)
    check(new_rows, "new_rows", torch.float32, 2, dev)
    check(row_map, "row_map", torch.int32, 2, dev)
    check(blk_idx, "blk_idx", torch.int32, 1, dev)
    C, W = slab.shape
    NB, B = row_map.shape
    if new_rows.shape[1] != W:
        raise ValueError("new_rows width %d != slab width %d"
                         % (new_rows.shape[1], W))
    if blk_idx.shape[0] != NB:
        raise ValueError("blk_idx length %d != row_map slots %d"
                         % (blk_idx.shape[0], NB))
    if B <= 0 or C % B:
        raise ValueError("block rows %d must divide slab rows %d" % (B, C))
    if not use_kernel(dev):
        blocked_write_plain(slab, new_rows, row_map, blk_idx)
        return
    from paddlebox_tpu_torch.native.build import load_kernel
    lib = load_kernel("blocked_write")
    if NB:
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.pbt_blocked_write(
                slab.data_ptr(), new_rows.data_ptr(), row_map.data_ptr(),
                blk_idx.data_ptr(), NB, B, W, stream)
        raise_on(rc, "blocked_write")
        blocked_write.launches += 1


blocked_write.launches = 0


def blocked_write_plain(slab: torch.Tensor, new_rows: torch.Tensor,
                        row_map: torch.Tensor, blk_idx: torch.Tensor) -> None:
    """The kernel's function in PyTorch ops: gather the placed lanes' source
    rows and write them at their slab rows (in place)."""
    B = row_map.shape[1]
    flat = row_map.reshape(-1)
    lanes = torch.nonzero(flat >= 0).squeeze(1)
    dest = blk_idx.to(torch.int64)[lanes // B] * B + lanes % B
    slab[dest] = new_rows[flat[lanes].to(torch.int64)]


def launch_counts() -> dict:
    """Launch counts of both kernels, by kernel name."""
    return {"push_adagrad": push_adagrad.launches,
            "blocked_write": blocked_write.launches}


def reset_launch_counts() -> None:
    push_adagrad.launches = 0
    blocked_write.launches = 0

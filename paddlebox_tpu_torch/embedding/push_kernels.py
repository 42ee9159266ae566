"""The sparse push's two kernels: wrappers, plain versions, launch counts.

  push_adagrad   <- paddlebox_tpu/embedding/pallas_push.py:_push_kernel
                    (pallas_apply_push) with the merge, row gather and row
                    scatter of optimizers.py:275-345 fused around it, source
                    csrc/push_adagrad.cu; plain version push_adagrad_fused_
                    plain, which composes merge_push_grads, a slab row
                    gather, push_adagrad_plain (the per-row update, the TPU
                    kernel's exact counterpart) and the row write
  blocked_write  <- paddlebox_tpu/embedding/pallas_push.py:
                    _blocked_write_kernel (pallas_blocked_write), source
                    csrc/blocked_write.cu

Both take the f32 slab or the bf16 slab diet's int16 one
(embedding/accessor.py): push_adagrad then decodes each row on read and
encodes it on write (the reference's decode and encode around the TPU
kernel, optimizers.py:259-262, 306-316, 342-343), blocked_write moves the
2-byte bits. Each form counts its launches apart (``launches_bf16``,
``launches_2byte``).

Each wrapper checks dtype, shape, contiguity and device, then:
  * on CPU tensors runs its plain PyTorch version (that is what the CPU
    tests exercise);
  * on CUDA tensors launches its kernel on the current stream, raises if
    the launch reports an error, and adds one to ``<wrapper>.launches``.
There is no fallback from the card to the plain version: a CUDA tensor
either goes through the kernel or the call raises. The plain versions stay
callable on the card, where chip_smoke.py holds each kernel against them.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from paddlebox_tpu_torch.config.configs import SparseOptimizerConfig
from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import (PushLayout, ValueLayout,
                                                    decode_slab_rows,
                                                    encode_slab_rows,
                                                    slab_codec_columns)
from paddlebox_tpu_torch.native.kernel_args import (check, raise_on,
                                                    use_kernel)


# ------------------------------------------------------------ push_adagrad

# the embedx widths csrc/push_adagrad.cu is built for (its template
# instantiations); the plain version takes any width
KERNEL_EMBEDX_DIMS = (2, 4, 8, 16, 32, 64)


def _conf_floats(conf: SparseOptimizerConfig):
    """PushConf order of csrc/push_adagrad.cu."""
    return (conf.nonclk_coeff, conf.clk_coeff, float(conf.nodeid_slot),
            conf.mf_learning_rate, conf.feature_learning_rate,
            conf.mf_initial_g2sum, conf.mf_min_bound, conf.mf_max_bound,
            conf.mf_create_thresholds, conf.mf_initial_range)


def push_adagrad(slab: torch.Tensor, grads: torch.Tensor,
                 perm: torch.Tensor, offsets: torch.Tensor,
                 uids: torch.Tensor, n_uniq: int, seed: int,
                 layout: ValueLayout, conf: SparseOptimizerConfig,
                 rows_out: bool = False) -> Optional[torch.Tensor]:
    """The fused push of one step over the batch's n_uniq uniques: merge
    each unique's per-occurrence push rows, update its slab row with
    in-table adagrad (creation randoms keyed by the uid and ``seed``, a
    nonnegative int32) and write it.

    slab [C, width] f32, or under a bf16 layout [C, device_width] int16
    (each row decoded, updated in f32 and encoded back; rows out are then
    encoded int16 rows [n_uniq, device_width]); grads [K, 4+D] f32 per-occurrence push rows; perm
    [K] int32 occurrences grouped by unique; offsets [K+1] int32, unique j's
    occurrences being perm[offsets[j]:offsets[j+1]]
    (pass_table.segment_offsets); uids [K] int32 strictly ascending, the
    first n_uniq of them distinct slab rows (not checked: that would cost
    a device sync).

    rows_out=False: the rows are written IN PLACE at slab[uids[j]], and
    None is returned. rows_out=True: the slab is left as it is and the
    new rows [n_uniq, width] are returned, row j for uids[j], pass-through
    rows included."""
    if layout.optimizer != "adagrad":
        raise ValueError("push_adagrad supports the adagrad layout only")
    dev = slab.device
    check(slab, "slab", layout.device_dtype, 2, dev)
    check(grads, "grads", torch.float32, 2, dev)
    for t, name in ((perm, "perm"), (offsets, "offsets"), (uids, "uids")):
        check(t, name, torch.int32, 1, dev)
    K = perm.shape[0]
    if slab.shape[1] != layout.device_width:
        raise ValueError("slab width %d != layout device width %d"
                         % (slab.shape[1], layout.device_width))
    G = PushLayout(layout.embedx_dim).width
    if grads.shape != (K, G):
        raise ValueError("grads shape %s != (%d, %d)"
                         % (tuple(grads.shape), K, G))
    if offsets.shape[0] != K + 1 or uids.shape[0] != K:
        raise ValueError("offsets length %d / uids length %d, expected %d / "
                         "%d" % (offsets.shape[0], uids.shape[0], K + 1, K))
    if not 0 <= int(n_uniq) <= min(K, slab.shape[0]):
        raise ValueError("n_uniq %r outside [0, %d]"
                         % (n_uniq, min(K, slab.shape[0])))
    if not 0 <= int(seed) < 2**31:
        raise ValueError("seed must be a nonnegative int32, got %r" % seed)
    n_uniq = int(n_uniq)
    if not use_kernel(dev):
        return push_adagrad_fused_plain(slab, grads, perm, offsets, uids,
                                        n_uniq, seed, layout, conf, rows_out)
    if layout.embedx_dim not in KERNEL_EMBEDX_DIMS:
        raise ValueError("push_adagrad kernel is built for embedx widths %s, "
                         "got %d" % (KERNEL_EMBEDX_DIMS, layout.embedx_dim))
    from paddlebox_tpu_torch.native.build import load_kernel
    lib = load_kernel("push_adagrad")
    out = (torch.empty((n_uniq, layout.device_width),
                       dtype=layout.device_dtype, device=dev)
           if rows_out else None)
    if n_uniq:
        cf = (ctypes.c_float * 10)(*_conf_floats(conf))
        args = (slab.data_ptr(), grads.data_ptr(), perm.data_ptr(),
                offsets.data_ptr(), uids.data_ptr(),
                None if out is None else out.data_ptr(), n_uniq,
                layout.embedx_dim, int(seed), cf)
        if layout.bf16:
            cols = slab_codec_columns(layout)
            fn = lib.pbt_push_adagrad_bf16
            args += ((ctypes.c_int * len(cols))(*cols),)
        else:
            fn = lib.pbt_push_adagrad
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(*args, stream)
        raise_on(rc, "push_adagrad")
        if layout.bf16:
            push_adagrad.launches_bf16 += 1
        else:
            push_adagrad.launches += 1
    return out


push_adagrad.launches = 0
push_adagrad.launches_bf16 = 0


def merge_push_grads(grads: torch.Tensor, perm: torch.Tensor,
                     offsets: torch.Tensor) -> torch.Tensor:
    """[U, G] per-unique sums of the per-occurrence push rows, U =
    len(offsets) - 1: unique j sums grads[perm[offsets[j]:offsets[j+1]]].

    Each run is added from its first occurrence up, starting at 0 (the
    order of the JAX sorted segment_sum; an empty run merges to a zero
    row). Occurrences past offsets[-1] (the padding tail, whose rows are
    zero and all address the trash row) are left out."""
    return torch.segment_reduce(grads.index_select(0, perm), "sum",
                                offsets=offsets.to(torch.int64), axis=0,
                                unsafe=True)


def push_adagrad_fused_plain(slab: torch.Tensor, grads: torch.Tensor,
                             perm: torch.Tensor, offsets: torch.Tensor,
                             uids: torch.Tensor, n_uniq: int, seed: int,
                             layout: ValueLayout, conf: SparseOptimizerConfig,
                             rows_out: bool = False
                             ) -> Optional[torch.Tensor]:
    """push_adagrad's function in PyTorch ops: merge_push_grads, the slab
    rows of the n_uniq uids (decoded under a bf16 layout),
    push_adagrad_plain, then the rows (encoded under a bf16 layout)
    written at their uids (or returned, rows_out=True)."""
    idx = uids[:n_uniq]
    merged = merge_push_grads(grads, perm, offsets[:n_uniq + 1])
    new_rows = encode_slab_rows(push_adagrad_plain(
        decode_slab_rows(slab.index_select(0, idx), layout), merged, idx,
        seed, layout, conf), layout)
    if rows_out:
        return new_rows
    slab.index_copy_(0, idx.to(torch.int64), new_rows)
    return None


def push_adagrad_plain(values: torch.Tensor, grads: torch.Tensor,
                       row_ids: torch.Tensor, seed: int, layout: ValueLayout,
                       conf: SparseOptimizerConfig) -> torch.Tensor:
    """The in-table update of the TPU kernel (pallas_apply_push) in
    PyTorch ops: updated rows [U, width] for value rows ``values``, merged
    push grads ``grads`` [U, 4+D] and slab ids ``row_ids`` [U] int32 (they
    key the creation randoms). It takes the fused kernel's f32 operation
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
    slab[blk_idx[i] * B + r] = new_rows[row_map[i, r]]. slab [C, W] and
    new_rows [U, W] both f32, or both int16 (the bf16 slab's bits),
    row_map [NB, B] int32 (values < U), blk_idx [NB] int32 block ids in
    [0, C // B)."""
    dev = slab.device
    if slab.dtype not in (torch.float32, torch.int16):
        raise TypeError("slab must be torch.float32 or torch.int16, got %s"
                        % slab.dtype)
    check(slab, "slab", slab.dtype, 2, dev)
    check(new_rows, "new_rows", slab.dtype, 2, dev)
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
        two = slab.dtype == torch.int16
        fn = lib.pbt_blocked_write_2byte if two else lib.pbt_blocked_write
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = fn(slab.data_ptr(), new_rows.data_ptr(), row_map.data_ptr(),
                    blk_idx.data_ptr(), NB, B, W, stream)
        raise_on(rc, "blocked_write")
        if two:
            blocked_write.launches_2byte += 1
        else:
            blocked_write.launches += 1


blocked_write.launches = 0
blocked_write.launches_2byte = 0


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
    """Launch counts of both kernels, by kernel form (f32, and the bf16
    slab's)."""
    return {"push_adagrad": push_adagrad.launches,
            "push_adagrad_bf16": push_adagrad.launches_bf16,
            "blocked_write": blocked_write.launches,
            "blocked_write_2byte": blocked_write.launches_2byte}


def reset_launch_counts() -> None:
    push_adagrad.launches = 0
    push_adagrad.launches_bf16 = 0
    blocked_write.launches = 0
    blocked_write.launches_2byte = 0

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

``push_adagrad`` is the name of the fused push; it carries every in-table
rule of the reference's ``apply_push`` (optimizers.py:73-225): adagrad
(the TPU kernel's), adam, adam_shared and naive, and the expand block with
adagrad or naive, each a template instantiation of csrc/push_adagrad.cu
(a thread a unique, or a warp a unique for the rows wider than 48
columns: the expand block). The rules other than adagrad run in XLA in
the reference, so the fused kernel and push_adagrad_plain are their only
counterparts here. Two rules of the TPU kernel hold for every layout
(ROADMAP, deliberate differences): created columns come from its integer
hash of (row id, column, seed), embedx column c hashing c and expand
column e hashing D + e, not from apply_push's threefry draws; and
adagrad's embed_w learning rate is picked by the UPDATED slot, where
apply_push reads the row's old one.

Both take the f32 slab or the bf16 slab diet's int16 one
(embedding/accessor.py): push_adagrad then decodes each row on read and
encodes it on write (the reference's decode and encode around the TPU
kernel, optimizers.py:259-262, 306-316, 342-343), blocked_write moves the
2-byte bits. Each form counts its launches apart (``launch_counts()``:
``push_form(layout)`` names a push form, ``blocked_write_2byte`` the 2-byte
placement).

Each wrapper checks dtype, shape, contiguity and device, then:
  * on CPU tensors runs its plain PyTorch version (that is what the CPU
    tests exercise);
  * on CUDA tensors launches its kernel on the current stream, raises if
    the launch reports an error, and adds one to its form's count.
There is no fallback from the card to the plain version: a CUDA tensor
either goes through the kernel or the call raises (a layout the kernel is
not built for raises too). The plain versions stay callable on the card,
where chip_smoke.py holds each kernel against them.
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

# the layouts csrc/push_adagrad.cu is built for (its template
# instantiations, f32 and bf16 slab alike); the plain version takes any
# layout. Adagrad without the expand block at every embedx width below;
# adam, adam_shared and naive at KERNEL_RULE_DIMS; the expand block (with
# adagrad or naive) at the (embedx, expand) widths of KERNEL_EXPAND_DIMS:
# the widths the configurations use (train/flagship.py). Another width is
# one line here and one in the kernel's dispatch.
KERNEL_EMBEDX_DIMS = (2, 4, 8, 16, 32, 64)
KERNEL_RULE_DIMS = (8,)
KERNEL_EXPAND_DIMS = ((8, 64),)
# the rule's ordinal in csrc/push_adagrad.cu (enum Rule)
KERNEL_RULES = {"adagrad": 0, "adam": 1, "adam_shared": 2, "naive": 3}


def kernel_built_for(layout: ValueLayout) -> bool:
    """Whether csrc/push_adagrad.cu has an instantiation for ``layout``."""
    D, E = layout.embedx_dim, layout.expand_dim
    if E:
        return (D, E) in KERNEL_EXPAND_DIMS
    if layout.optimizer == "adagrad":
        return D in KERNEL_EMBEDX_DIMS
    return D in KERNEL_RULE_DIMS


def push_form(layout: ValueLayout) -> str:
    """The name a push form counts its launches under: push_<rule>, then
    _expand with the expand block, then _bf16 on the bf16 slab
    (push_adagrad and push_adagrad_bf16 for the adagrad table)."""
    return ("push_" + layout.optimizer
            + ("_expand" if layout.expand_dim else "")
            + ("_bf16" if layout.bf16 else ""))


_push_launches = {
    "push_" + rule + expand + bf16: 0
    for rule, expand in (("adagrad", ""), ("adam", ""), ("adam_shared", ""),
                         ("naive", ""), ("adagrad", "_expand"),
                         ("naive", "_expand"))
    for bf16 in ("", "_bf16")}


def _conf_floats(conf: SparseOptimizerConfig):
    """PushConf order of csrc/push_adagrad.cu. Each 1 - beta is the Python
    double rounded to f32, as the reference's weakly typed ``(1.0 - beta1)
    * scaled`` rounds it."""
    return (conf.nonclk_coeff, conf.clk_coeff, float(conf.nodeid_slot),
            conf.mf_learning_rate, conf.feature_learning_rate,
            conf.mf_initial_g2sum, conf.mf_min_bound, conf.mf_max_bound,
            conf.mf_create_thresholds, conf.mf_initial_range,
            conf.learning_rate, conf.min_bound, conf.max_bound,
            conf.beta1_decay_rate, conf.beta2_decay_rate,
            1.0 - conf.beta1_decay_rate, 1.0 - conf.beta2_decay_rate,
            conf.ada_epsilon,
            conf.mf_beta1_decay_rate, conf.mf_beta2_decay_rate,
            1.0 - conf.mf_beta1_decay_rate, 1.0 - conf.mf_beta2_decay_rate,
            conf.mf_ada_epsilon)


def push_adagrad(slab: torch.Tensor, grads: torch.Tensor,
                 perm: torch.Tensor, offsets: torch.Tensor,
                 uids: torch.Tensor, n_uniq: int, seed: int,
                 layout: ValueLayout, conf: SparseOptimizerConfig,
                 rows_out: bool = False) -> Optional[torch.Tensor]:
    """The fused push of one step over the batch's n_uniq uniques: merge
    each unique's per-occurrence push rows, update its slab row with the
    table's in-table rule (``layout.optimizer``, with the expand block
    when ``layout.expand_dim``; creation randoms keyed by the uid and
    ``seed``, a nonnegative int32) and write it.

    slab [C, width] f32, or under a bf16 layout [C, device_width] int16
    (each row decoded, updated in f32 and encoded back; rows out are then
    encoded int16 rows [n_uniq, device_width]); grads [K, 4+D+E] f32
    per-occurrence push rows; perm [K] int32 occurrences grouped by
    unique; offsets [K+1] int32, unique j's occurrences being
    perm[offsets[j]:offsets[j+1]] (pass_table.segment_offsets); uids [K]
    int32 strictly ascending, the first n_uniq of them distinct slab rows
    (not checked: that would cost a device sync).

    rows_out=False: the rows are written IN PLACE at slab[uids[j]], and
    None is returned. rows_out=True: the slab is left as it is and the
    new rows [n_uniq, width] are returned, row j for uids[j], pass-through
    rows included."""
    dev = slab.device
    check(slab, "slab", layout.device_dtype, 2, dev)
    check(grads, "grads", torch.float32, 2, dev)
    for t, name in ((perm, "perm"), (offsets, "offsets"), (uids, "uids")):
        check(t, name, torch.int32, 1, dev)
    K = perm.shape[0]
    if slab.shape[1] != layout.device_width:
        raise ValueError("slab width %d != layout device width %d"
                         % (slab.shape[1], layout.device_width))
    G = PushLayout.of(layout).width
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
    if not kernel_built_for(layout):
        raise ValueError(
            "push_adagrad kernel is not built for %s (embedx %d, expand %d):"
            " adagrad at embedx %s, adam/adam_shared/naive at %s, the expand "
            "block at (embedx, expand) %s"
            % (layout.optimizer, layout.embedx_dim, layout.expand_dim,
               KERNEL_EMBEDX_DIMS, KERNEL_RULE_DIMS, KERNEL_EXPAND_DIMS))
    from paddlebox_tpu_torch.native.build import load_kernel
    lib = load_kernel("push_adagrad")
    out = (torch.empty((n_uniq, layout.device_width),
                       dtype=layout.device_dtype, device=dev)
           if rows_out else None)
    if n_uniq:
        cf = _conf_floats(conf)
        cols = slab_codec_columns(layout) if layout.bf16 else ()
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            rc = lib.pbt_push(
                slab.data_ptr(), grads.data_ptr(), perm.data_ptr(),
                offsets.data_ptr(), uids.data_ptr(),
                None if out is None else out.data_ptr(), n_uniq,
                KERNEL_RULES[layout.optimizer], layout.embedx_dim,
                layout.expand_dim, int(layout.bf16), int(seed),
                (ctypes.c_float * len(cf))(*cf),
                (ctypes.c_int * len(cols))(*cols) if cols else None,
                stream)
        raise_on(rc, "push_adagrad")
        _push_launches[push_form(layout)] += 1
    return out


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


def _fresh(row_ids: torch.Tensor, col0: int, n: int, seed: int,
           initial_range: torch.Tensor) -> torch.Tensor:
    """[U, n] creation randoms of columns col0 .. col0 + n: the TPU
    kernel's uint32 hash of (row id, column, seed) (pallas_push.py:86-98),
    its >> 8 -> int32 -> f32 step, times mf_initial_range."""
    mask32 = 0xFFFFFFFF
    r = row_ids.to(torch.int64) & mask32
    cols = torch.arange(col0, col0 + n, dtype=torch.int64,
                        device=row_ids.device)
    bits = ((r[:, None] * 2654435761) & mask32) ^ (
        (cols[None, :] * 40503 + (int(seed) & mask32)) & mask32)
    bits = (bits * 747796405 + 2891336453) & mask32
    bits = bits ^ (bits >> 16)
    u01 = (bits >> 8).to(torch.int32).to(torch.float32) * torch.tensor(
        1.0 / (1 << 24), dtype=torch.float32, device=row_ids.device)
    return u01 * initial_range


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """[U] sums of the columns of x [U, n], added from column 0 up (the
    kernel's order)."""
    acc_ = torch.zeros_like(x[:, 0])
    for c in range(x.shape[1]):
        acc_ = acc_ + x[:, c]
    return acc_


def push_adagrad_plain(values: torch.Tensor, grads: torch.Tensor,
                       row_ids: torch.Tensor, seed: int, layout: ValueLayout,
                       conf: SparseOptimizerConfig) -> torch.Tensor:
    """The in-table update in PyTorch ops: updated rows [U, width] for
    value rows ``values``, merged push grads ``grads`` [U, 4+D+E] and slab
    ids ``row_ids`` [U] int32 (they key the creation randoms), by the
    layout's rule. For adagrad without the expand block this is the TPU
    kernel (pallas_apply_push); for the other rules and the expand block
    it is apply_push (optimizers.py:73-225) with the TPU kernel's creation
    hash and updated-slot learning rate. It takes the fused kernel's f32
    operation order (each mean summed from column 0 up, then divided; no
    contracted multiply-add), so on the card the two agree bit for bit;
    XLA on the CPU contracts some of apply_push's adam products into
    FMAs, so against it the float columns agree to rounding."""
    D, E = layout.embedx_dim, layout.expand_dim
    push = PushLayout.of(layout)
    dev = values.device
    rule = layout.optimizer

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
    out = values.clone()

    def adam_step(w, m, v, b1p, b2p, s, b1, b2, omb1, omb2, eps):
        """(new w, m, v) of _adam_step (optimizers.py:46-55); the bound is
        mf_min_bound / mf_max_bound, the rate learning_rate."""
        ratio = f(conf.learning_rate) * torch.sqrt(1.0 - b2p) / (1.0 - b1p)
        nm = b1 * m + omb1 * s
        nv = b2 * v + omb2 * s * s
        neww = torch.clamp(w + ratio * (nm / (torch.sqrt(nv) + eps)), lo, hi)
        return neww, nm, nv

    # embed_w and its state: every active row
    es = layout.embed_state
    w = values[:, acc.EMBED_W]
    sw = grads[:, push.EMBED_G] / scale
    if rule == "adagrad":
        lr = torch.where(slot == float(conf.nodeid_slot),
                         f(conf.mf_learning_rate),
                         f(conf.feature_learning_rate))
        g2 = values[:, es]
        ratio = lr * torch.sqrt(ig2 / (ig2 + g2))
        out[:, acc.EMBED_W] = torch.clamp(w + ratio * sw, lo, hi)
        out[:, es] = g2 + sw * sw
    elif rule in ("adam", "adam_shared"):
        b1, b2 = f(conf.beta1_decay_rate), f(conf.beta2_decay_rate)
        b1p, b2p = values[:, es + 2], values[:, es + 3]
        out[:, acc.EMBED_W], out[:, es], out[:, es + 1] = adam_step(
            w, values[:, es], values[:, es + 1], b1p, b2p, sw, b1, b2,
            f(1.0 - conf.beta1_decay_rate), f(1.0 - conf.beta2_decay_rate),
            f(conf.ada_epsilon))
        out[:, es + 2] = b1p * b1
        out[:, es + 3] = b2p * b2
    else:  # naive
        out[:, acc.EMBED_W] = torch.clamp(
            w + f(conf.learning_rate) * sw, f(conf.min_bound),
            f(conf.max_bound))

    # embedx and its state: created, else updated once it exists
    xw, xs = layout.embedx_w, layout.embedx_state
    x = values[:, xw:xw + D]
    sx = grads[:, push.embedx_g:push.embedx_g + D] / scale[:, None]
    new_state = {}   # first state column -> its new columns [U, n]
    if rule == "adagrad":
        xg2 = values[:, xs]
        xratio = f(conf.mf_learning_rate) * torch.sqrt(ig2 / (ig2 + xg2))
        newx = torch.clamp(x + xratio[:, None] * sx, lo, hi)
        new_state[xs] = (xg2 + _row_sum(sx * sx) / f(float(D)))[:, None]
    elif rule == "adam":
        mb1, mb2 = f(conf.mf_beta1_decay_rate), f(conf.mf_beta2_decay_rate)
        xb1, xb2 = values[:, xs + 2 * D], values[:, xs + 2 * D + 1]
        newx, nm, nv = adam_step(
            x, values[:, xs:xs + D], values[:, xs + D:xs + 2 * D],
            xb1[:, None], xb2[:, None], sx, mb1, mb2,
            f(1.0 - conf.mf_beta1_decay_rate),
            f(1.0 - conf.mf_beta2_decay_rate), f(conf.mf_ada_epsilon))
        new_state[xs] = torch.cat(
            [nm, nv, (xb1 * mb1)[:, None], (xb2 * mb2)[:, None]], dim=1)
    elif rule == "adam_shared":
        mb1, mb2 = f(conf.mf_beta1_decay_rate), f(conf.mf_beta2_decay_rate)
        xm, xv = values[:, xs], values[:, xs + 1]
        xb1, xb2 = values[:, xs + 2], values[:, xs + 3]
        dd = f(float(D))
        gm = _row_sum(sx) / dd
        gsq = _row_sum(sx * sx) / dd
        ratio = f(conf.learning_rate) * torch.sqrt(1.0 - xb2) / (1.0 - xb1)
        nm = mb1 * xm + f(1.0 - conf.mf_beta1_decay_rate) * gm
        nv = mb2 * xv + f(1.0 - conf.mf_beta2_decay_rate) * gsq
        step = ratio * (nm / (torch.sqrt(nv) + f(conf.mf_ada_epsilon)))
        newx = torch.clamp(x + step[:, None], lo, hi)
        new_state[xs] = torch.stack([nm, nv, xb1 * mb1, xb2 * mb2], dim=1)
    else:  # naive
        newx = torch.clamp(x + f(conf.mf_learning_rate) * sx, lo, hi)

    mf_size = values[:, acc.MF_SIZE]
    score = nonclk * (show - click) + clk * click
    create = (mf_size == 0) & (score >= f(conf.mf_create_thresholds)) \
        & active
    has_mf = (mf_size > 0) & active
    irange = f(conf.mf_initial_range)
    out[:, xw:xw + D] = torch.where(
        create[:, None], _fresh(row_ids, 0, D, seed, irange),
        torch.where(has_mf[:, None], newx, x))

    # the expand block: the embedx gate, mf_learning_rate
    if E:
        ew = layout.expand_w
        e = values[:, ew:ew + E]
        se = grads[:, push.expand_g:push.expand_g + E] / scale[:, None]
        mlr = f(conf.mf_learning_rate)
        if rule == "adagrad":
            eg2 = values[:, layout.expand_state]
            eratio = mlr * torch.sqrt(ig2 / (ig2 + eg2))
            newe = torch.clamp(e + eratio[:, None] * se, lo, hi)
            new_state[layout.expand_state] = (
                eg2 + _row_sum(se * se) / f(float(E)))[:, None]
        else:  # naive
            newe = torch.clamp(e + mlr * se, lo, hi)
        out[:, ew:ew + E] = torch.where(
            create[:, None], _fresh(row_ids, D, E, seed, irange),
            torch.where(has_mf[:, None], newe, e))

    for col, new in new_state.items():
        n = new.shape[1]
        out[:, col:col + n] = torch.where(has_mf[:, None], new,
                                          values[:, col:col + n])
    out[:, acc.SLOT] = slot
    out[:, acc.SHOW] = show
    out[:, acc.CLICK] = click
    out[:, acc.DELTA_SCORE] = delta
    out[:, acc.UNSEEN_DAYS] = unseen
    out[:, acc.MF_SIZE] = torch.where(create, f(float(D)), mf_size)
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
    """Launch counts of both kernels, by kernel form (each push form, f32
    and the bf16 slab's, and both placements)."""
    return {**_push_launches,
            "blocked_write": blocked_write.launches,
            "blocked_write_2byte": blocked_write.launches_2byte}


def reset_launch_counts() -> None:
    for k in _push_launches:
        _push_launches[k] = 0
    blocked_write.launches = 0
    blocked_write.launches_2byte = 0

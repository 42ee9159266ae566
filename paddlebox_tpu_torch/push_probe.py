"""Device time of one train step's push at the flagship batch, on this tree
or on another checkout of the port.

    python3 paddlebox_tpu_torch/push_probe.py [--tree DIR] [--forms]

Builds one step's push inputs from seeds (``push_inputs``: the first
flagship batch's ids and their host dedup, a 2^20 x 17 slab whose touched
rows mix embedx creation, update and inactive rows, per-occurrence push
rows with zero padding rows) and runs the tree's
``embedding.optimizers.push_sparse_hostdedup`` on them as the train step
calls it, in each write mode (``WRITES``: 'scatter', 'blocked', and
'rebuild', ``push_sparse_rebuild`` with the host's position map, where the
tree has it). It prints the card's name and power limit, then one JSON
line with, for each mode:

  * ``slab_sha256``: the digest of the slab after one push from the same
    inputs; two trees that print the same digest wrote the same bits;
  * ``ms``: the push's device time, ``rate_probe.time_chain`` over copies
    of the inputs (the push writes the slab in place; where it reads its
    rows from the slab, a launch updates what the one before it wrote:
    the same bytes, other arithmetic);
  * ``device_ops``: the device operations of one push by name
    (torch.profiler).

``--tree DIR`` imports ``paddlebox_tpu_torch`` from DIR (``probe_tree``),
so the port's parent commit can be measured in the same call. Both designs of the push are understood: the
unfused one of the port's first slices (the pull's rows, first_idx,
n_valid) and the fused one (segment offsets).

``--forms`` times the fused kernel alone instead, at every form
(``FORMS``: each rule, the expand block, f32 and bf16 slab) on the first
flagship batch, and at the chunk shape (``CHUNK_FORMS``: the first 8
flagship batches' dedup, 410,407 uniques, the pipeline step's), each held
bit-equal to its plain version on the card in both write modes: one JSON
line with, for each form, rows out and in-place ms (``time_chain``), the
bytes and operations its function needs and the bound they give, and the
sha256 of its rows out (two trees that print the same digest wrote the same
bits).

``balanced_write_times`` times the three writes against each other in
rounds of BALANCED_WRITES (each ordered pair of distinct writes follows
once, as cadence_probe.BALANCED orders its four modes): chip_smoke.py's
phase 18 takes push_write='auto''s rule on the card from it, at the
flagship batch and at a chunk of 8 batches.
"""

from __future__ import annotations

import argparse
import dataclasses
import hashlib
import inspect
import json
import sys
import tempfile

SEED = 987654321
WRITES = ("scatter", "rebuild", "blocked")
# scatter (a), rebuild (b), blocked (c): each ordered pair of distinct
# writes follows once
BALANCED_WRITES = "abcacba"
# the fused kernel's forms --forms times: (rule, expand, slab dtype) at the
# flagship batch's embedx width, and the forms it times at the chunk shape
FORMS = tuple((rule, e, dt) for dt in ("float32", "bfloat16")
              for rule, e in (("adagrad", 0), ("adam", 0), ("adam_shared", 0),
                              ("naive", 0), ("adagrad", 64), ("naive", 64)))
CHUNK_FORMS = (("adagrad", 0, "float32"), ("adagrad", 64, "float32"))


def push_inputs(cfg, files, feed, ids=None):
    """One step's push inputs as numpy arrays (of the first flagship batch,
    or of the slab ids ``ids`` when given): ids [K], the slab [C, W],
    per-occurrence push rows grads [K, G], the host dedup (uids, perm, inv,
    n_uniq), n_valid, and per key slot ``live`` (a real key whose rows are
    not zero) and per slab row ``kind`` (0 create: mf_size 0; 1 update; 2
    inactive: every push row of the key is zero)."""
    import numpy as np

    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
    from paddlebox_tpu_torch.embedding.pass_table import dedup_ids
    from paddlebox_tpu_torch.train import flagship

    D, C = cfg.embedx, cfg.capacity
    layout, push = ValueLayout(D), PushLayout(D)
    W, G = layout.width, push.width
    if ids is None:
        ids = flagship.first_batch_ids(files, feed, cfg)
    K = ids.shape[0]
    uids, perm, inv, n_uniq = dedup_ids(ids, C)
    rng = np.random.RandomState(11)
    slab = np.zeros((C, W), np.float32)
    slab[:, acc.SLOT] = rng.randint(0, 32, C)
    slab[:, acc.SHOW] = rng.randint(1, 50, C)
    slab[:, acc.CLICK] = rng.randint(0, 5, C)
    slab[:, acc.EMBED_W] = rng.randn(C) * 0.1
    slab[:, layout.embed_state] = rng.rand(C)
    kind = rng.randint(0, 3, C)
    has_mf = kind != 0
    slab[has_mf, acc.MF_SIZE] = D
    xw = layout.embedx_w
    slab[has_mf, xw:xw + D] = rng.randn(int(has_mf.sum()), D) * 0.01
    slab[has_mf, layout.embedx_state] = rng.rand(int(has_mf.sum()))
    live = (ids != C - 1) & (kind[ids] != 2)
    grads = np.zeros((K, G), np.float32)
    grads[:, push.SLOT] = slab[ids, acc.SLOT] * live
    grads[:, push.SHOW] = live
    grads[:, push.CLICK] = rng.randint(0, 2, K) * live
    grads[:, push.EMBED_G] = rng.randn(K) * 0.2 * live
    grads[:, push.embedx_g:] = rng.randn(K, D) * 0.2 * live[:, None]
    return dict(ids=ids, slab=slab, grads=grads, uids=uids, perm=perm,
                inv=inv, n_uniq=n_uniq, n_valid=int((ids != C - 1).sum()),
                live=live, kind=kind)


def rule_rows(layout, base, conf):
    """f32 rows [C, width] of ``layout`` over the adagrad rows ``base``
    (push_inputs' slab): the header columns, embed_w and embedx
    of ``base``, every state column set (g2sums positive, adam moments
    small, beta powers one to five steps in) and the expand block on the
    rows that have embedx."""
    import numpy as np

    from paddlebox_tpu_torch.embedding import accessor as acc
    from paddlebox_tpu_torch.embedding.accessor import ValueLayout

    C, D, E = base.shape[0], layout.embedx_dim, layout.expand_dim
    rng = np.random.RandomState(13)
    rows = layout.new_rows(C, rng, conf)
    for c in (acc.SLOT, acc.SHOW, acc.CLICK, acc.EMBED_W, acc.MF_SIZE):
        rows[:, c] = base[:, c]
    bw = ValueLayout(D).embedx_w
    xw, es, xs = layout.embedx_w, layout.embed_state, layout.embedx_state
    rows[:, xw:xw + D] = base[:, bw:bw + D]

    def adam_state(at, moments):
        rows[:, at:at + moments] = rng.randn(C, moments) * 0.01
        rows[:, at + moments:at + 2 * moments] = rng.rand(C, moments) * 0.01
        rows[:, at + 2 * moments] = 0.9 ** rng.randint(1, 6, C)
        rows[:, at + 2 * moments + 1] = 0.999 ** rng.randint(1, 6, C)

    if layout.optimizer == "adagrad":
        rows[:, es] = rng.rand(C)
        rows[:, xs] = rng.rand(C)
    elif layout.optimizer != "naive":
        adam_state(es, 1)
        adam_state(xs, D if layout.optimizer == "adam" else 1)
    if E:
        has_mf = rows[:, acc.MF_SIZE] > 0
        rows[has_mf, layout.expand_w:layout.expand_w + E] = \
            rng.randn(int(has_mf.sum()), E) * 0.01
        if layout.expand_state_dim:
            rows[:, layout.expand_state] = rng.rand(C)
    return rows.astype(np.float32)


def rule_push_ops(layout, n_valid, n_active):
    """f32 operations of the fused push of ``layout``: the merge's adds,
    then per active unique the bookkeeping and its rule's update."""
    D, E = layout.embedx_dim, layout.expand_dim
    per_col = {"adagrad": 6, "adam": 12, "adam_shared": 4, "naive": 3}
    row = 20 + per_col[layout.optimizer] * D + (12 if layout.optimizer
                                                in ("adam",
                                                    "adam_shared") else 8)
    row += (6 if layout.optimizer == "adagrad" else 3) * E
    if layout.bf16:
        row += 4 * layout.width   # the decode and the encode
    return n_valid * (4 + D + E) + n_active * row


def fused_push_bytes(n_valid: int, n_uniq: int, W: int, G: int,
                     elem_bytes: int = 4) -> int:
    """What the fused push must move: each real occurrence's perm entry
    and push row, each unique's uid, offset, slab row read and row
    written (W slab columns of ``elem_bytes``: 4 for f32, 2 for the bf16
    slab's)."""
    return n_valid * (4 + G * 4) + n_uniq * (8 + 2 * W * elem_bytes)


def rebuild_write_bytes(capacity: int, n_uniq: int, W: int,
                        elem_bytes: int = 4) -> int:
    """What the rebuild write moves beyond the push: the gather of the new
    rows by the clamped position map (the map, each new row read once,
    each slab row written) and the select (the map, the gathered rows and
    the slab read, the slab written)."""
    row = W * elem_bytes
    return (capacity * 4 + (n_uniq + capacity) * row
            + capacity * 4 + 3 * capacity * row)


def _push_fn(optimizers, pass_table, inp, dev, layout, conf):
    """(design, fn, args): fn(*args, write) runs the tree's push on device
    tensors, whichever of its two signatures the tree has; 'rebuild' runs
    push_sparse_rebuild with the host's position map (fused trees that
    have it)."""
    import torch

    def t(x):
        return torch.from_numpy(x).to(dev)

    push = optimizers.push_sparse_hostdedup
    slab, uids, perm, grads = (t(inp[k]) for k in ("slab", "uids", "perm",
                                                   "grads"))
    n_uniq = inp["n_uniq"]
    if "first_idx" in inspect.signature(push).parameters:
        pulled = slab.index_select(0, t(inp["ids"]))
        first = t(pass_table.first_occurrence_idx(inp["perm"], inp["inv"]))

        def fn(slab, uids, perm, inv, grads, pulled, first, write):
            push(slab, uids, perm, inv, n_uniq, grads, SEED, layout, conf,
                 pulled_rows=pulled, first_idx=first,
                 n_valid=inp["n_valid"], write=write, block_rows=1024)
        return "unfused", fn, (slab, uids, perm, t(inp["inv"]), grads,
                               pulled, first)
    offsets = t(pass_table.segment_offsets(inp["inv"], inp["n_valid"]))
    rebuild = getattr(optimizers, "push_sparse_rebuild", None)
    pos = (t(pass_table.pos_for_rebuild(inp["uids"], slab.shape[0]))
           if rebuild is not None else None)

    def fn(slab, uids, perm, offsets, grads, write):
        if write == "rebuild":
            rebuild(slab, uids, pos, perm, offsets, n_uniq, grads, SEED,
                    layout, conf)
        else:
            push(slab, uids, perm, offsets, n_uniq, grads, SEED, layout,
                 conf, write=write, block_rows=1024)
    return "fused", fn, (slab, uids, perm, offsets, grads)


def balanced_write_times(inp, dev, layout, conf, rounds: int = 1):
    """{write: [ms of each timing]} of the fused push on ``inp``
    (push_inputs) under each of WRITES, timed by ``rate_probe.time_chain``
    in ``rounds`` rounds of BALANCED_WRITES (each write 2 or 3 times a
    round), and {write: slab sha256 after one push}: the three writes
    leave the same bits."""
    from paddlebox_tpu_torch.embedding import optimizers, pass_table
    from paddlebox_tpu_torch.embedding.accessor import PushLayout
    from paddlebox_tpu_torch.rate_probe import time_chain

    _, fn, args = _push_fn(optimizers, pass_table, inp, dev, layout, conf)
    W, G = layout.width, PushLayout.of(layout).width
    push_bytes = fused_push_bytes(inp["n_valid"], inp["n_uniq"], W, G)
    nbytes = {"scatter": push_bytes, "blocked": 2 * push_bytes,
              "rebuild": push_bytes + rebuild_write_bytes(
                  args[0].shape[0], inp["n_uniq"], W)}
    digests = {}
    for write in WRITES:
        slab = args[0].clone()
        fn(slab, *args[1:], write)
        digests[write] = hashlib.sha256(
            slab.cpu().numpy().tobytes()).hexdigest()
        del slab
    times = {w: [] for w in WRITES}
    for _ in range(rounds):
        for c in BALANCED_WRITES:
            write = WRITES["abc".index(c)]
            times[write].append(time_chain(
                lambda *a: fn(*a, write), (args[0].clone(),) + args[1:],
                nbytes[write]))
    return times, digests


def main(tree: str) -> int:
    """Measure the push of the ``paddlebox_tpu_torch`` on sys.path, which
    ``tree`` names."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.embedding import optimizers, pass_table
    from paddlebox_tpu_torch.embedding.accessor import PushLayout, ValueLayout
    from paddlebox_tpu_torch.rate_probe import time_chain
    from paddlebox_tpu_torch.train import flagship

    if not torch.cuda.is_available():
        raise SystemExit("push_probe needs a CUDA device")
    dev = torch.device("cuda")
    cfg = flagship.FLAGSHIP
    with tempfile.TemporaryDirectory(prefix="push_probe_") as tmp:
        files, feed = flagship.write_files(
            tmp, dataclasses.replace(cfg, num_files=1))
        inp = push_inputs(cfg, files, feed)
    layout, G = ValueLayout(cfg.embedx), PushLayout(cfg.embedx).width
    nbytes = fused_push_bytes(inp["n_valid"], inp["n_uniq"], layout.width, G)
    design, fn, args = _push_fn(optimizers, pass_table, inp, dev, layout,
                                cfg.table().optimizer)
    print(card_line(), flush=True)
    out = {"tree": tree, "design": design,
           "K": int(inp["ids"].shape[0]), "n_valid": inp["n_valid"],
           "n_uniq": inp["n_uniq"], "fused_bytes": nbytes}
    writes = [w for w in WRITES
              if w != "rebuild" or hasattr(optimizers, "push_sparse_rebuild")]
    for write in writes:
        slab = args[0].clone()
        fn(slab, *args[1:], write)
        digest = hashlib.sha256(slab.cpu().numpy().tobytes()).hexdigest()
        slab = args[0].clone()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(slab, *args[1:], write)
            torch.cuda.synchronize()
        ops = {}
        for e in prof.events():
            if str(getattr(e, "device_type", "")).endswith("CUDA"):
                ops[e.name[:90]] = ops.get(e.name[:90], 0) + 1
        # timed on a copy: the pristine slab stays for the next mode
        ms = time_chain(lambda *a: fn(*a, write),
                        (args[0].clone(),) + args[1:], nbytes)
        out[write] = {"ms": ms, "slab_sha256": digest, "device_ops": ops}
    print(json.dumps(out), flush=True)
    return 0


def form_records(cfg, files, feed, dev, forms, chunk=False):
    """{form name: record} of the fused kernel at each of ``forms`` on
    ``dev``, over the first flagship batch's push inputs (``chunk``: the
    first 8 batches'), every form held bit-equal to its plain version in
    both write modes (raises if not)."""
    import numpy as np
    import torch

    from paddlebox_tpu_torch.device import F32_FLOPS, HBM_BYTES_PER_S
    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.accessor import (PushLayout,
                                                        ValueLayout,
                                                        slab_rows_np)
    from paddlebox_tpu_torch.embedding.pass_table import segment_offsets
    from paddlebox_tpu_torch.rate_probe import time_chain
    from paddlebox_tpu_torch.train import flagship

    D = cfg.embedx
    conf = cfg.table().optimizer
    ids = flagship.first_chunk_ids(files, feed, cfg, 8) if chunk else None
    inp = push_inputs(cfg, files, feed, ids=ids)
    ids, live = inp["ids"], inp["live"]
    n_uniq, n_valid = inp["n_uniq"], inp["n_valid"]
    n_active = int(np.unique(ids[live]).size)
    p, o, u = (torch.from_numpy(x).to(dev) for x in (
        inp["perm"], segment_offsets(inp["inv"], n_valid), inp["uids"]))
    rng = np.random.RandomState(14)
    out = {}
    for rule, e, dt in forms:
        layout = ValueLayout(D, rule, e, dt)
        push = PushLayout.of(layout)
        grads = np.zeros((ids.shape[0], push.width), np.float32)
        grads[:, :4 + D] = inp["grads"]
        grads[:, push.expand_g:] = rng.randn(ids.shape[0], e) * 0.2 \
            * live[:, None]
        g = torch.from_numpy(grads).to(dev)
        slab = torch.from_numpy(slab_rows_np(
            rule_rows(layout, inp["slab"], conf), layout)).to(dev)
        rows = None
        for rows_out in (False, True):
            s_k, s_p = slab.clone(), slab.clone()
            got = pk.push_adagrad(s_k, g, p, o, u, n_uniq, SEED, layout,
                                  conf, rows_out)
            want = pk.push_adagrad_fused_plain(s_p, g, p, o, u, n_uniq, SEED,
                                               layout, conf, rows_out)
            same = torch.equal(s_k, s_p) if s_k.dtype == torch.int16 else \
                torch.equal(s_k.view(torch.int32), s_p.view(torch.int32))
            if rows_out:
                same = same and torch.equal(got.view(torch.int16),
                                            want.view(torch.int16))
                rows = got
            if not same:
                raise RuntimeError("%s (rows_out=%s) differs from the plain "
                                   "version" % (pk.push_form(layout),
                                                rows_out))
            del s_k, s_p, got, want
        nbytes = fused_push_bytes(n_valid, n_uniq, layout.device_width,
                                  push.width, 2 if layout.bf16 else 4)
        ops = rule_push_ops(layout, n_valid, n_active)
        args = (slab, g, p, o, u)
        out[pk.push_form(layout)] = {
            "W": layout.width, "device_width": layout.device_width,
            "G": push.width, "n_valid": n_valid, "n_uniq": n_uniq,
            "bytes": nbytes, "ops": ops,
            "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S, ops / F32_FLOPS),
            "ms": time_chain(lambda *a: pk.push_adagrad(
                *a, n_uniq, SEED, layout, conf, rows_out=True), args,
                nbytes),
            "in_place_ms": time_chain(lambda *a: pk.push_adagrad(
                *a, n_uniq, SEED, layout, conf), args, nbytes),
            "rows_sha256": hashlib.sha256(
                rows.cpu().numpy().tobytes()).hexdigest()}
        del slab, g, args, rows
    return out


def forms_main(tree: str) -> int:
    """--forms: the fused kernel at every form of the ``paddlebox_tpu_torch``
    on sys.path, which ``tree`` names."""
    import torch

    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.train import flagship

    if not torch.cuda.is_available():
        raise SystemExit("push_probe needs a CUDA device")
    dev = torch.device("cuda")
    cfg = flagship.FLAGSHIP
    print(card_line(), flush=True)
    with tempfile.TemporaryDirectory(prefix="push_probe_") as tmp:
        # two files: the chunk's 8 batches
        files, feed = flagship.write_files(
            tmp, dataclasses.replace(cfg, num_files=2))
        out = {"tree": tree,
               "flagship": form_records(cfg, files, feed, dev, FORMS),
               "chunk": form_records(cfg, files, feed, dev, CHUNK_FORMS,
                                     chunk=True)}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import probe_tree   # run by path: from this file's directory
    _ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _ap.add_argument("--forms", action="store_true",
                     help="time the fused kernel at every form")
    _args = probe_tree.parse_args(_ap)
    sys.exit((forms_main if _args.forms else main)(_args.tree))

"""Device time of the port's copy kernels at the flagship shapes and of the
streaming scale at the rate probe's, on this tree or on another checkout of
the port.

    python3 paddlebox_tpu_torch/copy_probe.py [--tree DIR] [--cases A,B]
    python3 paddlebox_tpu_torch/copy_probe.py --balanced N

Cases (inputs made from seeds, the same on every tree):

  blocked_write  the blocked path's placement of one flagship step
                 (``blocked_case``): a 2^20 x 17 slab, the first flagship
                 batch's sorted uids bucketized in blocks of
                 flagship.BLOCK_ROWS (1024 slots of 1024 lanes, 77,128 rows
                 placed), random new rows; library call: index_copy_ of the
                 same rows at their uids
  blocked_write_2byte    the same placement on the bf16 slab: a 2^20 x 25
                 int16 slab (flagship.FLAGSHIP_BF16's device width), random
                 int16 rows; library call: index_copy_ of the int16 rows
  blocked_write_chunk    the f32 placement at the density of a step of 8
                 flagship batches (``chunk_ids``: the first 8 batches'
                 1,048,576 ids, 410,407 distinct): 410,407 rows in 1024
                 slots; library call: index_copy_
  blocked_write_step     the f32 placement as the sharded pipeline step
                 makes it (``step_ids``): 410,406 of the pass's 557,083
                 slab rows and the trash row, so 545 slots of rows 74% of
                 them placed and 479 sentinel slots; library call:
                 index_copy_
  gather_pull    the pull (``rate_probe.pull_inputs``): the first flagship
                 batch's 131,072 ids (77,128 distinct, padding on the trash
                 row) into a 2^20 x 17 slab; library call: index_select
  gather_probe   the rate probe's gather (``rate_probe.probe_inputs``):
                 131,072 sorted unique ids from a 2^20 x 128 slab; library
                 call: index_select
  scale_64MB, scale_256MB    scale_copy over the rate probe's
                 [131072, 128] and [524288, 128] f32 (``probe_inputs``);
                 library call: ``rate_probe.torch_scale``, torch.add in one
                 pass
  scale_64MB_unaligned       the same 64 MiB one float into its buffer
                 (x not 16-byte aligned, the output aligned)

It prints the card's name and power limit, then one JSON line: for each
case the kernel's and the library call's device ms
(``rate_probe.time_chain``), the bytes the function must move and the
bound they give at 3.35 TB/s (a scale moves 2 x 4 x n bytes), and
``sha256``, the digest of the kernel's output (two trees that print the
same digests wrote the same bits; each copy's output is also held bit-equal
to the library call's, each scale's to its plain version); and ``floors``,
what the card gives at these sizes (``floors``, those of the cases run).
``--cases`` runs only the cases named (comma-separated).

``--tree DIR`` imports ``paddlebox_tpu_torch`` from DIR (``probe_tree``),
so the port's parent commit can be measured in the same call.

``--balanced N`` times only the four placements, each kernel (A) against
its ``index_copy_`` (B), N rounds of A, B, B, A in one process
(``rate_probe.balanced_rounds``, which the tree must have): one JSON
line a timing, then for each form each side's median and quartiles, the
per-round ratios A / B and the kernel's share of its bound.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys

import numpy as np


def bit_equal(a, b) -> bool:
    """Two tensors of one dtype (f32, or the bf16 slab's int16) hold the
    same bits."""
    import torch
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def chunk_ids() -> np.ndarray:
    """The first 8 flagship batches' ids, flat (flagship.first_chunk_ids
    over two synthetic files)."""
    import dataclasses
    import tempfile

    from paddlebox_tpu_torch.train import flagship

    cfg = flagship.FLAGSHIP
    with tempfile.TemporaryDirectory(prefix="copy_probe_") as tmp:
        files, feed = flagship.write_files(
            tmp, dataclasses.replace(cfg, num_files=2))
        return flagship.first_chunk_ids(files, feed, cfg, 8)


def step_ids(C: int = 1 << 20) -> np.ndarray:
    """Slab ids as a sharded pipeline step's push places them: a step's
    410,406 distinct served keys among a pass's 557,083 (their slab rows,
    which the pass table gives from 0 up, drawn from seed 28) and the trash
    row C - 1."""
    rows = np.random.RandomState(28).choice(557083, 410406, replace=False)
    return np.append(np.sort(rows), C - 1).astype(np.int32)


def blocked_case(ids: np.ndarray, C: int, W: int, dev,
                 two_byte: bool = False, name: str = None) -> dict:
    """blocked_write at one step of the blocked path on ``dev``: the
    sorted uids of ``ids`` (``pass_table.dedup_ids``) bucketized in blocks
    of flagship.BLOCK_ROWS lanes (``optimizers.blocked_layout``) over a
    random [C, W] slab (f32, or with ``two_byte`` random int16 bits, the
    bf16 slab's: case ``blocked_write_2byte``), with n_uniq random new
    rows as the fused push returns them. A dict: name, kernel, library
    (index_copy_ of the same rows at their uids), args (the slab
    untouched), library_args, bytes (what the function must move), info
    (shape facts). The kernel's result is held bit-equal to the library
    call's here (raises if not)."""
    import torch

    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.embedding.optimizers import blocked_layout
    from paddlebox_tpu_torch.embedding.pass_table import dedup_ids
    from paddlebox_tpu_torch.train import flagship

    uids, _, _, n_uniq = dedup_ids(ids, C)
    gen = torch.Generator(device=dev).manual_seed(5)
    if two_byte:
        def rows(n):
            return torch.randint(-1 << 15, 1 << 15, (n, W), generator=gen,
                                 device=dev, dtype=torch.int16)
    else:
        def rows(n):
            return torch.rand((n, W), generator=gen, device=dev)
    slab, new_rows = rows(C), rows(n_uniq)
    u = torch.from_numpy(uids).to(dev)
    row_map, blk_idx = blocked_layout(u, C, flagship.BLOCK_ROWS)
    idx = u[:n_uniq].to(torch.int64)
    s_k, s_l = slab.clone(), slab.clone()
    pk.blocked_write(s_k, new_rows, row_map, blk_idx)
    s_l.index_copy_(0, idx, new_rows)
    if not bit_equal(s_k, s_l):
        raise RuntimeError("blocked_write differs from index_copy_ of the "
                           "same rows")
    placed = int((row_map >= 0).sum())
    NB, B = row_map.shape
    return dict(name=name or ("blocked_write_2byte" if two_byte
                              else "blocked_write"),
                kernel=pk.blocked_write,
                library=lambda s, i, r: s.index_copy_(0, i, r),
                args=(slab, new_rows, row_map, blk_idx),
                library_args=(s_l, idx, new_rows),
                bytes=NB * B * 4 + NB * 4
                + placed * W * slab.element_size() * 2,
                info=dict(NB=NB, B=B, placed=placed, W=W))


def placement_cases(dev, pull=None) -> list:
    """The placements on ``dev``: the two at the flagship shapes (f32, and
    ``blocked_write_2byte`` at the bf16 slab's device width) and the f32
    one at the chunk's density and at the sharded pipeline step's
    (``blocked_write_chunk``, ``blocked_write_step``), each a dict as
    ``blocked_case`` gives; ``pull``: ``rate_probe.pull_inputs()``, made
    here when not given."""
    from paddlebox_tpu_torch.embedding.accessor import ValueLayout
    from paddlebox_tpu_torch.rate_probe import pull_inputs
    from paddlebox_tpu_torch.train import flagship

    pull_slab, pull_ids = pull if pull is not None else pull_inputs()
    cfg = flagship.FLAGSHIP_BF16
    W16 = ValueLayout(cfg.embedx,
                      embed_dtype=cfg.slab_embed_dtype).device_width
    return [blocked_case(pull_ids, *pull_slab.shape, dev),
            blocked_case(pull_ids, pull_slab.shape[0], W16, dev,
                         two_byte=True),
            blocked_case(chunk_ids(), *pull_slab.shape, dev,
                         name="blocked_write_chunk"),
            blocked_case(step_ids(pull_slab.shape[0]), *pull_slab.shape,
                         dev, name="blocked_write_step")]


def flagship_cases(dev, names=None) -> list:
    """The cases at the flagship shapes on ``dev`` (the two placements and
    the two gathers; ``names``: only those), each a dict as
    ``blocked_case`` gives; each gather's output is held bit-equal to
    index_select's (raises if not)."""
    import torch

    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.rate_probe import (gather_bytes, probe_inputs,
                                                pull_inputs)

    def wanted(name):
        return names is None or name in names

    pull_slab, pull_ids = pull_inputs()
    cases = [c for c in placement_cases(dev, (pull_slab, pull_ids))
             if wanted(c["name"])]
    _, p_slab, p_ids = probe_inputs()
    for name, s_np, i_np in (("gather_pull", pull_slab, pull_ids),
                             ("gather_probe", p_slab, p_ids)):
        if not wanted(name):
            continue
        src = torch.from_numpy(s_np).to(dev)
        i = torch.from_numpy(i_np).to(dev)
        if not bit_equal(rk.gather_rows(src, i), src.index_select(0, i)):
            raise RuntimeError("%s differs from index_select" % name)
        cases.append(dict(name=name, kernel=rk.gather_rows,
                          library=lambda a, b: a.index_select(0, b),
                          args=(src, i), library_args=(src, i),
                          bytes=gather_bytes(i_np, *s_np.shape),
                          info=dict(K=int(i_np.shape[0]),
                                    W=int(s_np.shape[1]))))
    return cases


def scale_cases(dev, names=None) -> list:
    """scale_copy at the rate probe's two sizes and at 64 MiB one float
    into its buffer, on ``dev`` (``names``: only those), each a dict as
    ``blocked_case`` gives; each output is held bit-equal to the plain
    version (raises if not)."""
    import torch

    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.rate_probe import probe_inputs, torch_scale

    xs = probe_inputs()[0]
    flat = torch.empty(xs[0].size + 1, device=dev)
    views = [("scale_64MB", torch.from_numpy(xs[0]).to(dev)),
             ("scale_256MB", torch.from_numpy(xs[1]).to(dev)),
             ("scale_64MB_unaligned", flat[1:].view(xs[0].shape))]
    views[2][1].copy_(views[0][1])
    cases = []
    for name, x in views:
        if names is not None and name not in names:
            continue
        if not bit_equal(rk.scale_copy(x), rk.scale_copy_plain(x)):
            raise RuntimeError("%s differs from the plain version" % name)
        cases.append(dict(name=name, kernel=rk.scale_copy,
                          library=torch_scale, args=(x,), library_args=(x,),
                          bytes=2 * 4 * x.numel(),
                          info=dict(shape=list(x.shape),
                                    byte_offset=x.data_ptr() % 16)))
    return cases


def floors(cases: list) -> dict:
    """What the card gives at these sizes (device ms, ``time_chain``),
    beside the cases of ``flagship_cases`` that ran. With the pull:
    ``launch_ms``, gather_rows of one id (a launch in the chain with next
    to no work); ``sequential_copy_ms``, scale_copy streaming as many bytes
    as the pull must move (``sequential_copy_bytes``), and
    ``device_copy_ms``, ``dst.copy_(src)`` of those bytes (the card's own
    device-to-device copy: the floor, which does not move with the kernel
    under redesign). With each placement (keys with ``_2byte`` for the
    2-byte one): ``blocked_contiguous_ms``, blocked_write of the same rows
    with each slot's placed lanes moved to its first lanes (whole sectors
    written); ``index_copy_contiguous_ms``, index_copy_ of the same rows at
    consecutive slab rows."""
    import torch

    from paddlebox_tpu_torch.embedding import push_kernels as pk
    from paddlebox_tpu_torch.ops import row_kernels as rk
    from paddlebox_tpu_torch.rate_probe import time_chain

    by = {c["name"]: c for c in cases}
    out = {}
    if "gather_pull" in by:
        src = by["gather_pull"]["args"][0]
        dev = src.device
        x = torch.rand((by["gather_pull"]["bytes"] // (8 * 128), 128),
                       device=dev)
        out.update({
            "launch_ms": time_chain(
                rk.gather_rows,
                (src[:64].clone(),
                 torch.zeros(1, dtype=torch.int32, device=dev)),
                4 + 2 * 4 * src.shape[1]),
            "sequential_copy_ms": time_chain(rk.scale_copy, (x,),
                                             x.numel() * 8),
            "sequential_copy_bytes": x.numel() * 8,
            "device_copy_ms": time_chain(lambda s, d: d.copy_(s),
                                         (x, torch.empty_like(x)),
                                         x.numel() * 8)})
    for name, suffix in (("blocked_write", ""),
                         ("blocked_write_2byte", "_2byte"),
                         ("blocked_write_chunk", "_chunk"),
                         ("blocked_write_step", "_step")):
        if name not in by:
            continue
        slab, new_rows, row_map, blk_idx = by[name]["args"]
        idx = by[name]["library_args"][1]
        nbytes = by[name]["bytes"]
        dev = slab.device
        placed = row_map >= 0
        lanes = torch.arange(row_map.shape[1], device=dev)
        front = torch.full_like(row_map, -1)
        front[lanes[None, :] < placed.sum(1, keepdim=True)] = \
            row_map[placed]
        out["blocked_contiguous%s_ms" % suffix] = time_chain(
            pk.blocked_write, (slab.clone(), new_rows, front, blk_idx),
            nbytes)
        out["index_copy_contiguous%s_ms" % suffix] = time_chain(
            lambda s, i, r: s.index_copy_(0, i, r),
            (slab.clone(), torch.arange(idx.numel(), device=dev),
             new_rows), nbytes)
    return out


def balanced(rounds: int) -> dict:
    """The four placements against their index_copy_, ``rounds`` rounds of
    A, B, B, A (``rate_probe.balanced_rounds``); prints one line a timing
    and the summary, and returns the summary, by form."""
    import torch

    from paddlebox_tpu_torch.device import HBM_BYTES_PER_S, card_line
    from paddlebox_tpu_torch.rate_probe import balanced_rounds, quartiles

    cases = placement_cases(torch.device("cuda"))
    got = balanced_rounds(
        {c["name"]: ((c["name"], c["kernel"], c["args"], c["bytes"]),
                     ("index_copy_", c["library"], c["library_args"],
                      c["bytes"]))
         for c in cases}, rounds, "case")
    summary = {"card": card_line()}
    for c in cases:
        g = got[c["name"]]
        bound = 1e3 * c["bytes"] / HBM_BYTES_PER_S
        kernel = quartiles(g["A"])
        summary[c["name"]] = dict(
            c["info"], bytes=c["bytes"], bound_ms=bound, kernel_ms=kernel,
            index_copy_ms=quartiles(g["B"]), ratios=g["ratios"],
            ratio_median=quartiles(g["ratios"])["median"],
            bound_share=bound / kernel["median"],
            faster_every_round=max(g["ratios"]) < 1.0)
    out = {"blocked_balanced": summary}
    print(json.dumps(out), flush=True)
    return out


def main(tree: str, names=None) -> int:
    """Measure the copy kernels of the ``paddlebox_tpu_torch`` on sys.path,
    which ``tree`` names (``names``: only those cases)."""
    import torch

    from paddlebox_tpu_torch.device import HBM_BYTES_PER_S, card_line
    from paddlebox_tpu_torch.rate_probe import time_chain

    if not torch.cuda.is_available():
        raise SystemExit("copy_probe needs a CUDA device")
    print(card_line(), flush=True)
    out = {"tree": tree}
    dev = torch.device("cuda")
    cases = flagship_cases(dev, names)
    for case in cases + scale_cases(dev, names):
        args = case["args"]
        if case["name"].startswith("blocked_write"):   # writes in place
            args = (args[0].clone(),) + args[1:]
        got = case["kernel"](*args)
        if got is None:
            got = args[0]
        digest = hashlib.sha256(got.cpu().numpy().tobytes()).hexdigest()
        nbytes = case["bytes"]
        out[case["name"]] = dict(
            case["info"], bytes=nbytes,
            bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
            ms=time_chain(case["kernel"], args, nbytes),
            library_ms=time_chain(case["library"], case["library_args"],
                                  nbytes),
            sha256=digest)
    out["floors"] = floors(cases)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    import probe_tree   # run by path: from this file's directory
    _ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _ap.add_argument("--cases", default=None,
                     help="comma-separated case names (default: all)")
    _ap.add_argument("--balanced", type=int, default=0,
                     help="rounds of the placements against index_copy_")
    _args = probe_tree.parse_args(_ap)
    if _args.balanced:
        import torch
        if not torch.cuda.is_available():
            raise SystemExit("copy_probe needs a CUDA device")
        balanced(_args.balanced)
        sys.exit(0)
    sys.exit(main(_args.tree, _args.cases and _args.cases.split(",")))

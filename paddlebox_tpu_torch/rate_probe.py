"""How close the port's hand-written kernels come to the card's memory rate.

    python3 -m paddlebox_tpu_torch.rate_probe [--scale-balanced N]

Port of tools/pallas_rate_probe.py, which asked on the TPU whether a
hand-written streaming kernel, and a row gather at the pull's shape, run at
the memory's rate or at the framework op's. Each kernel case also times the
kernel's plain version; each PyTorch case computes the same rows:

  kernel_scale_64MB        scale_copy, f32 [131072, 128]
  torch_scale_64MB         the same function in one PyTorch call (one pass)
  torch_scale_2op_64MB     x * 0.999 + 0.001, two PyTorch ops (two passes)
  ..._256MB                the same three at [524288, 128]
  kernel_gather_131k_rows, torch_gather_131k_rows_W128    gather_rows
      against index_select: 131,072 sorted unique ids from a [2^20, 128]
      slab
  kernel_gather_pull_W17, torch_gather_pull_W17    the same at the train
      step's pull: a [2^20, 17] slab and the 131,072 ids of one flagship
      batch (train/flagship.py), padding on the trash row included; the
      TPU probe had no such case

The scale arrays, the slab and the sorted ids are drawn as the TPU probe
draws them (numpy RandomState(0), in its order). The first line names the
card (nvidia-smi name and power limit); then one JSON line a case: whether
its output is bit-equal to the kernel's plain version, ms per call from
``time_chain``, GB/s of the bytes the case must move (each input read once,
each distinct source row read once, each output written once) and their
share of the H100's 3.35 TB/s, and for a kernel case its plain version's ms.

``time_chain`` is the one device timer of the port's kernel measurements:
chip_smoke.py times every kernel, plain version and library call with it.

``--scale-balanced N`` times only the scale, at 64 and 256 MiB: scale_copy
(A) against the one-call ``torch_scale`` (B), N rounds in one process, each
round A, B, B, A at each size in turn, one JSON line a timing, then for
each size each side's median, quartiles and the median of the per-round
ratios A / B (``scale_balanced``).

Runs on the card by default and raises without one. ``run(device="cpu",
sizes=...)`` runs the plain versions at the sizes given, once each and
untimed (the tests' route).
"""

from __future__ import annotations

import dataclasses
import json
import math
import statistics
import tempfile
import time
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from paddlebox_tpu_torch.device import (HBM_BYTES_PER_S, DeviceLike,
                                        card_line, resolve_device)
from paddlebox_tpu_torch.embedding.accessor import (ValueLayout,
                                                    encode_slab_rows_np)
from paddlebox_tpu_torch.ops.row_kernels import (SCALE, SHIFT, gather_rows,
                                                 gather_rows_plain,
                                                 scale_copy, scale_copy_plain)
from paddlebox_tpu_torch.train import flagship

REPS = 5
ITERS = 8
L2_BYTES = 50 << 20   # H100 L2
# the card spins ahead of each timed chain, so the host has queued all ITERS
# launches before the first one starts: about 2 ms at least, and at least
# twice the host's time to queue the warm-up chain (at up to 2 GHz)
SPIN_CYCLES = 4_000_000
SPIN_HZ = 2e9
MAX_SPIN_CYCLES = 2_000_000_000


@dataclasses.dataclass(frozen=True)
class ProbeSizes:
    scale_rows: Tuple[int, ...] = (1 << 17, 1 << 19)  # 64 and 256 MiB
    width: int = 128
    slab_rows: int = 1 << 20
    gather_rows: int = 131072
    pull: flagship.Flagship = flagship.FLAGSHIP


PROBE = ProbeSizes()


@dataclasses.dataclass
class Case:
    name: str
    fn: Callable[..., torch.Tensor]
    args: Tuple[torch.Tensor, ...]
    bytes: int          # what the function must move (see gather_bytes)
    plain: Callable[..., torch.Tensor]   # the kernel's plain version
    kernel: bool        # a hand-written kernel: it must match its plain


def torch_scale(x: torch.Tensor) -> torch.Tensor:
    """x * 0.999 + 0.001 in one PyTorch call, one pass over x: the library
    yardstick of scale_copy (timed only; the port never calls it)."""
    return torch.add(torch.tensor(SHIFT, dtype=torch.float32), x,
                     alpha=SCALE)


def gather_bytes(ids: np.ndarray, src_rows: int, width: int,
                 elem_bytes: int = 4) -> int:
    """Bytes a row gather must move: the ids, each distinct source row read
    once, each output row written once (rows of ``width`` elements of
    ``elem_bytes``: 4 for f32, 2 for the bf16 slab's; int32 ids)."""
    distinct = np.unique(np.minimum(ids, src_rows - 1)).size
    return ids.shape[0] * 4 + (distinct + ids.shape[0]) * width * elem_bytes


def _mb(nbytes: int) -> str:
    return "%dMB" % (nbytes >> 20) if nbytes >= 1 << 20 \
        else "%dKB" % (nbytes >> 10)


def _k(n: int) -> str:
    return "%dk" % (n // 1000) if n >= 1000 else str(n)


def probe_inputs(sizes: ProbeSizes = PROBE):
    """(scale arrays, slab, sorted unique ids) as numpy arrays, drawn as
    tools/pallas_rate_probe.py draws them."""
    rng = np.random.RandomState(0)
    xs = [rng.rand(rows, sizes.width).astype(np.float32)
          for rows in sizes.scale_rows]
    slab = rng.rand(sizes.slab_rows, sizes.width).astype(np.float32)
    ids = np.sort(rng.choice(sizes.slab_rows - 1, sizes.gather_rows,
                             replace=False)).astype(np.int32)
    return xs, slab, ids


def pull_inputs(cfg: flagship.Flagship = flagship.FLAGSHIP):
    """(slab [capacity, width] f32, ids [batch * slots * max_len] int32):
    a random slab and the first flagship batch's ids."""
    with tempfile.TemporaryDirectory(prefix="rate_probe_") as tmp:
        files, feed = flagship.write_files(
            tmp, dataclasses.replace(cfg, num_files=1))
        ids = flagship.first_batch_ids(files, feed, cfg)
    width = ValueLayout(cfg.embedx).width
    slab = np.random.RandomState(1).rand(cfg.capacity, width).astype(
        np.float32)
    return slab, ids


def pull_inputs_bf16(cfg: flagship.Flagship = flagship.FLAGSHIP_BF16):
    """(slab [capacity, device_width] uint16, ids): ``pull_inputs``' slab
    and ids with the slab's rows encoded by the bf16 diet's codec (the bits
    of an int16 slab on the card)."""
    slab, ids = pull_inputs(cfg)
    layout = ValueLayout(cfg.embedx, embed_dtype=cfg.slab_embed_dtype)
    return encode_slab_rows_np(slab, layout), ids


def cases(sizes: ProbeSizes, device: torch.device) -> List[Case]:
    """The probe's cases on ``device``, the kernel's first in each group."""
    xs, slab, ids = probe_inputs(sizes)
    pull_slab, pull_ids = pull_inputs(sizes.pull)
    out: List[Case] = []
    for x_np in xs:
        x = torch.from_numpy(x_np).to(device)
        nbytes = 2 * x.numel() * 4
        mb = _mb(x.numel() * 4)
        out += [Case("kernel_scale_" + mb, scale_copy, (x,), nbytes,
                     scale_copy_plain, True),
                Case("torch_scale_" + mb, torch_scale, (x,), nbytes,
                     scale_copy_plain, False),
                Case("torch_scale_2op_" + mb, lambda v: v * 0.999 + 0.001,
                     (x,), nbytes, scale_copy_plain, False)]
    for kname, tname, s_np, i_np in (
            ("kernel_gather_%s_rows" % _k(sizes.gather_rows),
             "torch_gather_%s_rows_W%d" % (_k(sizes.gather_rows),
                                          sizes.width), slab, ids),
            ("kernel_gather_pull_W%d" % pull_slab.shape[1],
             "torch_gather_pull_W%d" % pull_slab.shape[1], pull_slab,
             pull_ids)):
        s = torch.from_numpy(s_np).to(device)
        i = torch.from_numpy(i_np).to(device)
        nbytes = gather_bytes(i_np, *s_np.shape)
        out += [Case(kname, gather_rows, (s, i), nbytes, gather_rows_plain,
                     True),
                Case(tname, lambda a, b: a.index_select(0, b), (s, i),
                     nbytes, gather_rows_plain, False)]
    return out


def _copies(args: Sequence, nbytes: int) -> List[tuple]:
    """``args`` and clones of its tensors, enough that one pass over them
    moves at least twice the L2 (at most ITERS sets)."""
    n = min(ITERS, max(1, math.ceil(2 * L2_BYTES / max(nbytes, 1))))
    return [tuple(args)] + [
        tuple(a.clone() if isinstance(a, torch.Tensor) else a for a in args)
        for _ in range(n - 1)]


def time_chain(fn: Callable, args: Sequence, nbytes: int) -> float:
    """Device milliseconds a call of fn(*args) on the card: CUDA events
    around ITERS launches, the median of REPS chains after one warm-up
    chain. The host queues each chain while the card spins, so the events
    time the device and not the host's launch rate; the chain rotates over
    copies of the tensor arguments (``_copies``; ``nbytes`` is what one
    call moves), so a launch does not find its inputs left in L2 by the
    launches just before it; it keeps every output alive. fn may write its
    arguments in place if doing so twice gives the same result."""
    copies = _copies(args, nbytes)

    def chain():
        return [fn(*copies[j % len(copies)]) for j in range(ITERS)]

    t0 = time.perf_counter()
    chain()
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = min(MAX_SPIN_CYCLES, max(SPIN_CYCLES, int(2 * host_s * SPIN_HZ)))
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        outs = chain()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / ITERS)
        del outs
    return statistics.median(times)


def run(device: DeviceLike = None, sizes: ProbeSizes = PROBE) -> List[dict]:
    """Run every case and print one JSON line each (after one line naming
    the device); returns the case records. A kernel whose output is not
    bit-equal to its plain version raises."""
    dev = resolve_device(device)
    on_card = dev.type == "cuda"
    print(json.dumps({"device": torch.cuda.get_device_name(dev) if on_card
                      else "cpu",
                      "card": card_line() if on_card else None}), flush=True)
    records = []
    for case in cases(sizes, dev):
        got = case.fn(*case.args)
        want = case.plain(*case.args)
        equal = torch.equal(got.view(torch.int32), want.view(torch.int32))
        if case.kernel and not equal:
            raise RuntimeError("rate_probe: %s differs from its plain "
                               "version" % case.name)
        del got, want
        rec = {"op": case.name, "shape": [list(a.shape) for a in case.args],
               "bytes": case.bytes, "bit_equal_to_plain": equal,
               "ms_per_call": None, "gb_per_s": None, "share_of_hbm": None,
               "plain_ms": None}
        if on_card:
            ms = time_chain(case.fn, case.args, case.bytes)
            rate = case.bytes / (ms * 1e-3)
            rec.update(ms_per_call=ms, gb_per_s=rate / 1e9,
                       share_of_hbm=rate / HBM_BYTES_PER_S)
            if case.kernel:
                rec["plain_ms"] = time_chain(case.plain, case.args,
                                             case.bytes)
        print(json.dumps(rec), flush=True)
        records.append(rec)
    return records


def quartiles(xs: Sequence[float]) -> dict:
    """Median, quartiles (inclusive), min, max and count of ``xs``."""
    if len(xs) < 2:
        return {"median": xs[0], "q1": xs[0], "q3": xs[0], "min": xs[0],
                "max": xs[0], "n": len(xs)}
    q = statistics.quantiles(xs, n=4, method="inclusive")
    return {"median": q[1], "q1": q[0], "q3": q[2], "min": min(xs),
            "max": max(xs), "n": len(xs)}


def balanced_rounds(pairs: dict, rounds: int, key: str) -> dict:
    """Time two sides against each other, ``rounds`` rounds of A, B, B, A
    with ``time_chain``, the pairs in turn within a round. ``pairs``:
    label -> (A, B), each side (name, fn, args, nbytes). Prints one JSON
    line a timing (``key``: the label); returns label -> {"A": [ms],
    "B": [ms], "ratios": [the mean A / mean B of each round]}."""
    out = {label: {"A": [], "B": [], "ratios": []} for label in pairs}
    for r in range(rounds):
        for label, sides in pairs.items():
            got = {"A": [], "B": []}
            for pos, side in enumerate("ABBA"):
                name, fn, args, nbytes = sides["AB".index(side)]
                ms = time_chain(fn, args, nbytes)
                got[side].append(ms)
                print(json.dumps({"round": r, key: label, "pos": pos,
                                  "op": name, "ms": ms}), flush=True)
            for side in "AB":
                out[label][side] += got[side]
            out[label]["ratios"].append(statistics.mean(got["A"])
                                        / statistics.mean(got["B"]))
    return out


def scale_balanced(rounds: int, device: DeviceLike = None,
                   sizes: ProbeSizes = PROBE) -> dict:
    """scale_copy against torch_scale at each of the probe's scale sizes,
    ``rounds`` rounds of A, B, B, A a size on the same inputs; prints one
    line a timing and returns the summary, by size."""
    dev = resolve_device(device)
    xs = {_mb(x.size * 4): torch.from_numpy(x).to(dev)
          for x in probe_inputs(sizes)[0]}
    got = balanced_rounds(
        {mb: (("scale_copy", scale_copy, (x,), 2 * x.numel() * 4),
              ("torch_scale", torch_scale, (x,), 2 * x.numel() * 4))
         for mb, x in xs.items()}, rounds, "size")
    out = {"scale_balanced": {"card": card_line(), **{
        mb: {"bytes": 2 * x.numel() * 4,
             "scale_copy_ms": quartiles(got[mb]["A"]),
             "torch_scale_ms": quartiles(got[mb]["B"]),
             "ratio_a_over_b": quartiles(got[mb]["ratios"])}
        for mb, x in xs.items()}}}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    import argparse
    _ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    _ap.add_argument("--scale-balanced", type=int, default=0)
    _args = _ap.parse_args()
    if _args.scale_balanced:
        scale_balanced(_args.scale_balanced)
    else:
        run()

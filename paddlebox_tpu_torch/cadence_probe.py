"""The incremental cadence: its run modes, one run of a mode, and the probe
that times the modes against each other on one GPU.

    python3 -m paddlebox_tpu_torch.cadence_probe [--reps N]

The cadence (train/flagship.py write_cadence) trains three passes over
sliding windows of the flagship's files. ``run_cadence`` trains them in one
of ``MODES``:

  a  run_preloaded_passes, both PassFlags switches on: the next window
     loads, and the prefetcher reads its store-present rows, while this
     one trains
  b  one train_pass after another, incremental (there is no preload, so
     preload_promote has nothing to switch)
  c  one train_pass after another, full rebuild each pass
  d  run_preloaded_passes with preload_promote off: the next window loads
     while this one trains, nothing is prefetched

and returns one record a pass: loss and AUC, the trainer's phase seconds,
the table's begin_pass/end_pass seconds and row counters of that pass, and
the seconds the garbage collector paused the pass. chip_smoke.py's
cadence phase checks these records; this probe times them.

The probe writes the files once, runs mode a once as a warm-up (not
reported), then ``N`` times the order of ``BALANCED``, in which every
mode follows every other mode exactly once. Every run starts settled
(``settle``). Prints the card's name and power limit, one JSON line a run
(with the mode that ran before it and the objects the settle collected),
then one JSON line with each mode's median and quartiles of every pass's
phases and of the run's wall seconds, and each mode's first-phase seconds
of pass 0 by the mode that ran before it.

Needs a CUDA device; the times are host-clock seconds of passes that end
in a device sync (the end phase copies the losses back).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import tempfile
import time
from typing import Dict, List, Optional, Tuple

import torch

from paddlebox_tpu_torch.config.configs import DataFeedConfig
from paddlebox_tpu_torch.config.flags import PassFlags
from paddlebox_tpu_torch.data.dataset import BoxDataset
from paddlebox_tpu_torch.device import DeviceLike
from paddlebox_tpu_torch.train import flagship
from paddlebox_tpu_torch.train.preload import run_preloaded_passes
from paddlebox_tpu_torch.train.trainer import BoxTrainer

# mode: (label, the trainer's PassFlags, preloaded)
MODES = {
    "a": ("preloaded, incremental, prefetch", PassFlags(), True),
    "b": ("sequential, incremental", PassFlags(), False),
    "c": ("sequential, full rebuild", PassFlags(incremental_pass=False),
          False),
    "d": ("preloaded, incremental, no prefetch",
          PassFlags(preload_promote=False), True),
}
# after a warm-up run of "a": each ordered pair of distinct modes once
BALANCED = "bacadbcbdcda"


def settle() -> int:
    """Bring the process to the same state whatever ran before: collect
    the last run's objects and, with a card, wait for it and release the
    allocator's cached blocks. Returns the objects gc found unreachable."""
    collected = gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return collected


class _GcClock:
    """Seconds the garbage collector has paused the process while
    installed (gc.callbacks)."""

    def __init__(self) -> None:
        self.seconds = 0.0
        self._t0 = 0.0

    def __call__(self, phase: str, info: Dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.seconds += time.perf_counter() - self._t0


def run_cadence(mode: str, windows: List[List[str]], feed: DataFeedConfig,
                cfg: flagship.Flagship = flagship.FLAGSHIP,
                device: DeviceLike = None) -> Tuple[BoxTrainer, Dict]:
    """Settle, build the flagship trainer (seed 0) with ``mode``'s flags
    and train one pass over each of ``windows``. Returns (the trainer,
    {"mode", "label", "collected", "wall_s", "passes": one record a
    pass}); wall_s runs from the first pass's start to the last pass's
    end, the device synchronised."""
    label, flags, preloaded = MODES[mode]
    collected = settle()
    trainer, _ = flagship.build_trainer(windows[0], feed, cfg, "scatter",
                                        device, pass_flags=flags)
    table = trainer.table
    clock = _GcClock()
    passes: List[Dict] = []
    before = [dict(table.counters), dict(table.seconds), 0.0]

    def after_pass(i: int, res: Dict) -> None:
        times = dict(trainer.pass_times)
        passes.append({
            "pass": i, "loss": res["loss"],
            "auc": trainer.metrics.get_metric_msg("auc")["auc"],
            "batches": res["batches"], "instances": res["instances"],
            "phase_s": times,
            "table_s": {k: v - before[1][k]
                        for k, v in table.seconds.items()},
            "counters": {k: v - before[0][k]
                         for k, v in table.counters.items()},
            "gc_s": clock.seconds - before[2],
            "examples_per_s": res["instances"] / sum(times.values())})
        before[:] = [dict(table.counters), dict(table.seconds),
                     clock.seconds]

    datasets = []
    for files in windows:
        datasets.append(BoxDataset(feed))
        datasets[-1].set_filelist(files)
    gc.callbacks.append(clock)
    try:
        t0 = time.perf_counter()
        if preloaded:
            run_preloaded_passes(trainer, datasets, after_pass=after_pass)
        else:
            for i, ds in enumerate(datasets):
                after_pass(i, trainer.train_pass(ds))
        if trainer.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        gc.callbacks.remove(clock)
    return trainer, {"mode": mode, "label": label, "collected": collected,
                     "wall_s": wall, "passes": passes}


def _quartiles(xs):
    q = statistics.quantiles(xs, n=4, method="inclusive") if len(xs) > 1 \
        else [xs[0]] * 3
    return {"median": q[1], "q1": q[0], "q3": q[2], "n": len(xs)}


def summarise(runs: List[Dict], n_passes: int) -> Dict:
    """Each mode's quartiles of every pass's phases, table seconds, gc
    seconds and examples/s and of the run's wall seconds, and its pass 0
    first-phase seconds (feed or wait) by the mode that ran before."""
    out = {}
    for mode in MODES:
        mine = [r for r in runs if r["mode"] == mode]
        if not mine:
            continue
        per_pass = []
        for p in range(n_passes):
            got = [r["passes"][p] for r in mine]
            row = {name: _quartiles([g[k][name] for g in got])
                   for k in ("phase_s", "table_s")
                   for name in got[0][k]}
            for name in ("gc_s", "examples_per_s"):
                row[name] = _quartiles([g[name] for g in got])
            per_pass.append(row)
        first: Dict[str, List[float]] = {}
        for r in mine:
            first.setdefault(r["after"], []).append(
                next(iter(r["passes"][0]["phase_s"].values())))
        out[mode] = {"label": MODES[mode][0],
                     "wall_s": _quartiles([r["wall_s"] for r in mine]),
                     "passes": per_pass, "pass0_first_phase_by_after": first}
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)

    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.native.build import build_kernels

    if not torch.cuda.is_available():
        raise SystemExit("cadence_probe needs a CUDA device")
    print(card_line(), flush=True)
    build_kernels()
    order = "a" + BALANCED * args.reps
    runs = []
    with tempfile.TemporaryDirectory(prefix="cadence_probe_") as tmp:
        windows, feed = flagship.write_cadence(tmp)
        for i, mode in enumerate(order):
            trainer, run = run_cadence(mode, windows, feed, device="cuda")
            del trainer
            run["after"] = order[i - 1] if i else None
            print(json.dumps(run), flush=True)
            if i:  # the first run is the warm-up
                runs.append(run)
    print(json.dumps({"card": card_line(),
                      "summary": summarise(runs, len(windows))}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

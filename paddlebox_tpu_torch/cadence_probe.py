"""The incremental cadence: its run modes, one run of a mode, and the probe
that times the modes against each other on one GPU.

    python3 -m paddlebox_tpu_torch.cadence_probe [--reps N]
    python3 paddlebox_tpu_torch/cadence_probe.py [--reps N] [--tree DIR]

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
the seconds the garbage collector paused the pass; and the host tier the
run took (the dataset's path and the store's class). chip_smoke.py's
cadence phase checks these records; this probe times them.

The probe writes the files once, runs mode a once as a warm-up (not
reported), then ``N`` times the order of ``BALANCED``, in which every
mode follows every other mode exactly once. Every run starts settled
(``settle``). Prints the card's name and power limit, one JSON line a run
(with the mode that ran before it and the objects the settle collected),
then one JSON line with each mode's median and quartiles of every pass's
phases and of the run's wall seconds, and each mode's first-phase seconds
of pass 0 by the mode that ran before it.

``--tree DIR`` (run by path; probe_tree.py) imports ``paddlebox_tpu_torch``
from DIR, so the port's parent commit unpacked in a git-ignored directory
runs the same protocol in the same chip call, in turns (parent, change,
change, parent). Every line then carries the tree.

Needs a CUDA device; the times are host-clock seconds of passes that end
in a device sync (the end phase copies the losses back).
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import tempfile
import sys
import time
from typing import TYPE_CHECKING, Dict, List, Optional, Tuple

# run by path with --tree, this file imports nothing but the standard
# library before probe_tree has put the tree on sys.path: torch and the
# package's modules are imported inside the functions
if TYPE_CHECKING:
    from paddlebox_tpu_torch.config.configs import DataFeedConfig
    from paddlebox_tpu_torch.device import DeviceLike
    from paddlebox_tpu_torch.train.flagship import Flagship
    from paddlebox_tpu_torch.train.trainer import BoxTrainer

# mode: (label, the trainer's PassFlags fields, preloaded)
MODES = {
    "a": ("preloaded, incremental, prefetch", {}, True),
    "b": ("sequential, incremental", {}, False),
    "c": ("sequential, full rebuild", {"incremental_pass": False}, False),
    "d": ("preloaded, incremental, no prefetch",
          {"preload_promote": False}, True),
}
# after a warm-up run of "a": each ordered pair of distinct modes once
BALANCED = "bacadbcbdcda"


def settle() -> int:
    """Bring the process to the same state whatever ran before: collect
    the last run's objects and, with a card, wait for it and release the
    allocator's cached blocks. Returns the objects gc found unreachable."""
    import torch

    collected = gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return collected


class GcClock:
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
                cfg: Optional[Flagship] = None,
                device: DeviceLike = None) -> Tuple[BoxTrainer, Dict]:
    """Settle, build the flagship trainer (seed 0; ``cfg`` defaults to
    FLAGSHIP) with ``mode``'s flags and train one pass over each of
    ``windows``. Returns (the trainer, {"mode", "label", "host_tier",
    "collected", "wall_s", "passes": one record a pass}); wall_s runs from
    the first pass's start to the last pass's end, the device
    synchronised."""
    import torch

    from paddlebox_tpu_torch.config.flags import PassFlags
    from paddlebox_tpu_torch.data.dataset import BoxDataset
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.train.preload import run_preloaded_passes

    label, flag_fields, preloaded = MODES[mode]
    collected = settle()
    trainer, _ = flagship.build_trainer(
        windows[0], feed, flagship.FLAGSHIP if cfg is None else cfg,
        "scatter", device, pass_flags=PassFlags(**flag_fields))
    table = trainer.table
    clock = GcClock()
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
    host_tier = {"dataset": ("columnar" if getattr(datasets[0], "columnar",
                                                   False) else "record"),
                 "store": type(table.store).__name__}
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
    return trainer, {"mode": mode, "label": label, "host_tier": host_tier,
                     "collected": collected, "wall_s": wall,
                     "passes": passes}


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


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=2)
    return ap


def main(argv: Optional[List[str]] = None) -> int:
    return measure(_parser().parse_args(argv).reps)


def measure(reps: int, tree: Optional[str] = None) -> int:
    """The probe's protocol on the ``paddlebox_tpu_torch`` that is on
    sys.path (``tree`` names it in the output)."""
    import torch

    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.native.build import build_kernels
    from paddlebox_tpu_torch.train import flagship

    if not torch.cuda.is_available():
        raise SystemExit("cadence_probe needs a CUDA device")
    print(card_line(), flush=True)
    build_kernels()
    order = "a" + BALANCED * reps
    runs = []
    with tempfile.TemporaryDirectory(prefix="cadence_probe_") as tmp:
        windows, feed = flagship.write_cadence(tmp)
        for i, mode in enumerate(order):
            trainer, run = run_cadence(mode, windows, feed, device="cuda")
            del trainer
            run["after"] = order[i - 1] if i else None
            run["tree"] = tree
            print(json.dumps(run), flush=True)
            if i:  # the first run is the warm-up
                runs.append(run)
    print(json.dumps({"card": card_line(), "tree": tree,
                      "host_tier": runs[-1]["host_tier"] if runs else None,
                      "summary": summarise(runs, len(windows))}), flush=True)
    return 0


if __name__ == "__main__":
    if __package__:   # python3 -m paddlebox_tpu_torch.cadence_probe
        sys.exit(main())
    import probe_tree   # run by path: from this file's directory
    _args = probe_tree.parse_args(_parser())
    sys.exit(measure(_args.reps, _args.tree))

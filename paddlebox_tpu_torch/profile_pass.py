"""Where a full-width train pass spends its time on the GPU.

    python3 -m paddlebox_tpu_torch.profile_pass [--out DIR]
    python3 paddlebox_tpu_torch/profile_pass.py [--out DIR] [--tree DIR]

Builds the flagship trainer and data (train/flagship.py, the configuration
whose two passes chip_smoke.py drives as its main path), runs the first
pass as a warm-up, then profiles the second with torch.profiler (CPU + CUDA
activity). With the incremental lifecycle (the default) the second pass is
a delta promote that keeps every row on the device, and a touched-row
write-back; its row counters are printed. ``--tree DIR`` (run by path;
probe_tree.py) profiles the ``paddlebox_tpu_torch`` of DIR, so the
parent's port (one step at a time) and this one (chunks of 8 through the
chunk driver) run in the same call. It prints:

  * one JSON line: the pass's host phase seconds (BoxTrainer.pass_times),
    the bytes it copied host to device by leaf (``h2d_bytes``: the
    chunks' stacked and chunk leaves and the tail batches' arrays, as
    ``count_h2d_bytes`` tallies them; the push's products differ by wire),
    the step loop's wall seconds, the device busy seconds inside it (the
    union of all GPU kernel and copy intervals), the idle share, and each
    of the port's own kernels' calls, device seconds and share of the busy
    time (the pull is gather_rows, the push push_adagrad); inside the
    step's push (run under a profiler span in this script only) the
    device launches (``push_launches``, runtime calls by name) and the
    PyTorch operators (``push_torch_ops``); and the pass's calls of the
    PyTorch operators the unfused push ran (``torch_op_calls``: the click
    lookup keeps one index_select a step, the pool one searchsorted and
    one segment_reduce); and the pass's host-to-device copies by kind
    (``h2d_copies``: pinned or pageable source, count and device
    seconds);
  * the 25 device operators with the most GPU time (key_averages).

While the pass is profiled, the span tracer opens a
``torch.profiler.record_function`` beside each span (``annotated_spans``),
so the trainer's spans (host_stage, scan_dispatch, chunk_drain, the ingest
spans) land in the profiler's trace.

Needs a CUDA device; writes the Chrome trace to DIR/pass_trace.json when
--out is given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
from typing import Dict, Optional


def _busy_union(intervals):
    """Total length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


PUSH_SPAN = "sparse_push"
# tracer spans a chunked pass opens on the calling thread (traced_pass)
TRACE_SPANS = ("scan_dispatch", "chunk_drain")
# the PyTorch operators the unfused push ran
PUSH_TORCH_OPS = ("aten::index_select", "aten::searchsorted",
                  "aten::segment_reduce", "aten::index_copy_")


def _push_ops(events):
    """(spans, launches, ops) of the pass's push: its host-side PUSH_SPAN
    spans; the runtime calls inside them that put work on the device
    (cudaLaunchKernel, cudaMemcpyAsync, ...), by name; and the outermost
    PyTorch operators called inside them, by name. Counts are over the
    pass."""
    launches, ops = {}, {}

    def walk(e, in_op):
        for ch in e.cpu_children:
            n = ch.name
            if n.startswith("cu") and any(w in n for w in ("Launch", "Memcpy",
                                                           "Memset")):
                launches[n] = launches.get(n, 0) + 1
            elif n.startswith("aten::") and not in_op:
                ops[n] = ops.get(n, 0) + 1
            walk(ch, in_op or n.startswith("aten::"))

    spans = [e for e in events if e.name == PUSH_SPAN
             and str(e.device_type).endswith("CPU")]
    for span in spans:
        walk(span, False)
    return len(spans), launches, ops


def h2d_copies(device_events) -> Dict[str, Dict[str, float]]:
    """The host-to-device copies among ``device_events`` (the profiler's
    CUDA events), by the kind of their host memory: {"pinned": {"copies",
    "device_s"}, "pageable": {...}}."""
    out = {kind: {"copies": 0, "device_s": 0.0}
           for kind in ("pinned", "pageable")}
    for e in device_events:
        name = e.name
        if "HtoD" not in name:
            continue
        kind = "pinned" if "Pinned" in name else "pageable"
        out[kind]["copies"] += 1
        out[kind]["device_s"] += (e.time_range.end
                                  - e.time_range.start) / 1e6
    return out


class annotated_spans:
    """Within the block, every span of the tracer also opens a
    ``torch.profiler.record_function`` of its name (obs/tracer.py
    ``set_annotation``); the annotation is off again after it."""

    def __enter__(self) -> "annotated_spans":
        import torch

        from paddlebox_tpu_torch.obs import tracer
        tracer.set_annotation(torch.profiler.record_function)
        return self

    def __exit__(self, *exc) -> None:
        from paddlebox_tpu_torch.obs import tracer
        tracer.set_annotation(None)


class count_h2d_bytes:
    """Within the block, tally the bytes ``trainer`` moves host to device,
    by leaf name (``self.bytes``): each array of the host chunks its
    chunk driver copies (``_group_to_device``: a batch's leaves and a
    chunk's push products) and of the batches it steps one at a time
    (``device_batch``). Host ints (n_valid, n_uniq, uid_base, uid_cut)
    ride as kernel arguments and are not counted."""

    def __init__(self, trainer) -> None:
        self.trainer = trainer
        self.bytes: Dict[str, int] = {}

    def _add(self, k: str, n: int) -> None:
        self.bytes[k] = self.bytes.get(k, 0) + int(n)

    def __enter__(self) -> "count_h2d_bytes":
        import numpy as np
        import torch

        t = self.trainer
        group, single = t._group_to_device, t.device_batch

        def group_to_device(hosts):
            for h in hosts:
                for leaves in (*h.batches, h.cpush):
                    for k, v in leaves.items():
                        if isinstance(v, np.ndarray):
                            self._add(k, v.nbytes)
            return group(hosts)

        def device_batch(b, ids):
            out = single(b, ids)
            for k, v in out.items():
                if isinstance(v, torch.Tensor):
                    self._add(k, v.element_size() * v.numel())
            return out

        t._group_to_device, t.device_batch = group_to_device, device_batch
        return self

    def __exit__(self, *exc) -> None:
        del self.trainer._group_to_device, self.trainer.device_batch


def profile_pass(trainer, ds, out_dir: str = "", warmup: bool = True):
    """Warm the trainer up with one pass (unless ``warmup`` is False: it
    has trained already), then profile its next one: (the record printed
    as this script's JSON line, the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from paddlebox_tpu_torch.device import card_line
    from paddlebox_tpu_torch.native.build import KERNEL_SOURCES
    from paddlebox_tpu_torch.train import trainer as trainer_mod

    # the train step looks its push up by name at each call: the
    # dispatch by wire, or an earlier tree's one push
    name = ("sparse_push" if hasattr(trainer_mod, "sparse_push")
            else "push_sparse_hostdedup")
    push = getattr(trainer_mod, name)

    def traced_push(*a, **kw):
        with torch.profiler.record_function(PUSH_SPAN):
            push(*a, **kw)

    setattr(trainer_mod, name, traced_push)
    try:
        if warmup:
            trainer.train_pass(ds)  # allocator, cuBLAS, kernels
        torch.cuda.synchronize()
        with count_h2d_bytes(trainer) as h2d_bytes, annotated_spans(), \
                profile(activities=[ProfilerActivity.CPU,
                                    ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = trainer.train_pass(ds)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        setattr(trainer_mod, name, push)
    dev = [e for e in prof.events()
           if getattr(e, "device_type", None) is not None
           and str(e.device_type).endswith("CUDA")]
    intervals = [(e.time_range.start, e.time_range.end) for e in dev]
    busy_s = _busy_union(intervals) / 1e6
    steps_s = trainer.pass_times.get("steps", 0.0)
    span_s = ((max(e for _, e in intervals) - min(s for s, _ in intervals))
              / 1e6 if intervals else 0.0)
    ours = {}
    for name in KERNEL_SOURCES:
        mine = [e for e in dev if name + "_kernel" in e.name]
        secs = sum(e.time_range.end - e.time_range.start for e in mine) / 1e6
        ours[name] = {"calls": len(mine), "device_s": secs,
                      "share_of_busy": secs / busy_s if busy_s else None}
    spans, push_launches, push_ops = _push_ops(prof.events())
    op_calls = {a.key: a.count for a in prof.key_averages()
                if a.key in PUSH_TORCH_OPS}
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out_dir, "pass_trace.json"))
    return {
        "card": card_line(),
        "scan_chunk": getattr(getattr(trainer, "cfg", None), "scan_chunk",
                              None),
        "batches": res["batches"], "pass_wall_s": wall,
        "phase_s": trainer.pass_times,
        "device_events": len(dev), "device_busy_s": busy_s,
        "device_span_s": span_s,
        "idle_share_of_pass": (1.0 - busy_s / wall) if wall else None,
        "idle_share_of_device_span": ((1.0 - busy_s / span_s)
                                      if span_s else None),
        "steps_per_s_host": (res["batches"] / steps_s) if steps_s else None,
        "port_kernels": ours,
        "table_counters": trainer.table.counters,
        "push_spans": spans, "push_launches": push_launches,
        "push_torch_ops": push_ops,
        "torch_op_calls": {k: op_calls.get(k, 0) for k in PUSH_TORCH_OPS},
        "h2d_copies": h2d_copies(dev),
        "h2d_bytes": h2d_bytes.bytes,
    }, prof


def profile_config(cfg, files, feed) -> Dict[str, object]:
    """The record of ``profile_pass`` for flagship configuration ``cfg``
    over ``files`` (``feed``'s), its first pass the warm-up, made in the
    calling process. Run it as a process's first torch.profiler session:
    a later session in the same process has come back short of device
    events."""
    from paddlebox_tpu_torch.train import flagship

    trainer, ds = flagship.build_trainer(files, feed, cfg, device="cuda")
    try:
        return profile_pass(trainer, ds)[0]
    finally:
        trainer.close()


def traced_pass(cfg, files, feed, logdir: str) -> Dict[str, object]:
    """One pass of flagship configuration ``cfg`` over ``files`` inside
    utils/profiler.trace(``logdir``), made in the calling process (run it
    as the process's first torch.profiler session): the pass's loss and
    AUC, and of the chrome trace it wrote the event count, the calls of
    each port kernel and the tracer spans it holds."""
    import torch

    from paddlebox_tpu_torch.native.build import KERNEL_SOURCES
    from paddlebox_tpu_torch.train import flagship
    from paddlebox_tpu_torch.utils import profiler

    trainer, ds = flagship.build_trainer(files, feed, cfg, device="cuda")
    try:
        with profiler.trace(logdir):
            res = trainer.train_pass(ds)
            torch.cuda.synchronize()
        auc = trainer.metrics.get_metric_msg("auc")["auc"]
    finally:
        trainer.close()
    with open(os.path.join(logdir, "trace.json")) as fh:
        events = json.load(fh)["traceEvents"]
    names = [e.get("name", "") for e in events]
    return {"loss": res["loss"], "auc": auc, "batches": res["batches"],
            "events": len(events),
            "kernel_calls": {k: sum(k + "_kernel" in n for n in names)
                             for k in KERNEL_SOURCES},
            "spans": sorted({n for n in names if n in TRACE_SPANS})}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="")
    return ap


def main(argv=None) -> int:
    return measure(_parser().parse_args(argv).out)


def measure(out_dir: str, tree: Optional[str] = None) -> int:
    """Profile the flagship's second pass on the ``paddlebox_tpu_torch``
    that is on sys.path (``tree`` names it in the output)."""
    import torch

    from paddlebox_tpu_torch.train import flagship

    if not torch.cuda.is_available():
        raise SystemExit("profile_pass needs a CUDA device")
    with tempfile.TemporaryDirectory(prefix="profile_pass_") as tmp:
        files, feed = flagship.write_files(tmp)
        trainer, ds = flagship.build_trainer(files, feed, device="cuda")
        rec, prof = profile_pass(trainer, ds, out_dir)
    rec["tree"] = tree
    print(json.dumps(rec), flush=True)
    print(prof.key_averages().table(sort_by="device_time_total",
                                    row_limit=25), flush=True)
    return 0


if __name__ == "__main__":
    if __package__:   # python3 -m paddlebox_tpu_torch.profile_pass
        raise SystemExit(main())
    import probe_tree   # run by path: from this file's directory
    _args = probe_tree.parse_args(_parser())
    sys.exit(measure(_args.out, _args.tree))

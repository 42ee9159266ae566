"""The device plane: the obs tier that watches the card below the host
planes (paddlebox_tpu/obs/device.py, the same stat, gauge and snapshot
names).

  * ``instrument_step(fn, name, slab_of=...)`` wraps the trainer's step
    entry points (train_step, scan_steps, scan_chunk, eval_step,
    train_step_async). There is no XLA compile to count: a call is keyed by
    the (structure, shape, dtype) signature of its tensor arguments (host
    ints and other scalars by type, not value), as the reference keys its
    executable cache (device.py:403-415). On this port a new signature is
    what would force a new kernel grid and a CUDA-graph recapture
    (ROADMAP A9). The entry's ``compiles`` counts the calls that brought a
    new signature and ``compile_ms`` their host milliseconds (such a first
    call pays the allocator's and the libraries' warm-up); ``signatures``
    is the number kept. A new signature past ``device_recompile_warmup``
    counts ``device_recompiles`` and is logged loudly once a function. The
    reference's one-time ``analyze_compiled`` cost and memory analyses have
    no counterpart here (nothing is compiled at a call), so no entry
    carries ``analysis``.
  * the donation audit: the port updates the slab in place, so for an
    entry point given ``slab_of`` (the table's slab after the call) the
    audit compares the slab argument's ``data_ptr()`` before the call with
    the slab the table holds after it. A slab that came back at another
    address was copied: ``donation_miss``, counted only when the same
    signature's previous audited call also missed (the reference's
    debounce), and never for slabs below ``device_donation_min_bytes``.
  * the transfer ledger: ``account_h2d`` / ``account_d2h`` feed the
    counters ``device_transfer_bytes_{h2d,d2h}`` and the histograms
    ``device_{h2d,d2h}_bytes``. The pass table calls them at its full
    build, its delta promote and its write-back, the staging ring at its
    pinned copies and the trainer at a tail batch's copies; each site
    names its ``kind``, kept beside the counters (``transfer_kinds``).
  * the HBM ledger: ``register_owner(name, getter)`` (the trainer
    registers ``slab``, ``dense_params`` and ``opt_state``);
    ``sample_ledger`` sums each owner's tensors' bytes into
    ``device_live_bytes_<owner>``, ``other`` being
    ``torch.cuda.memory_allocated()`` less the owners' sum on the card (0
    on the CPU), the total, the owners' tensor count, the allocator's peak
    (``device_live_bytes_peak``, on the card) and the leak detector
    ``device_leak_suspect`` across ``device_leak_windows`` samples of
    strictly growing total.

Everything lands in the StatRegistry, so StepReports, /metrics, the flight
recorder's seal and /device carry it. ``configure(flags)`` (the reporter
factory calls it) takes ObsFlags: with ``device_obs`` off,
``instrument_step`` returns the bare function and the ledgers record
nothing.
"""

from __future__ import annotations

import time
from collections import OrderedDict
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from paddlebox_tpu_torch.config.flags import ObsFlags
from paddlebox_tpu_torch.utils.lockwatch import make_lock, make_rlock
from paddlebox_tpu_torch.utils.stats import (gauge_set, hist_observe,
                                             stat_add, stat_peek)

SCHEMA_VERSION = 1

#: signatures kept a function (LRU); the sentinel fires long before this
MAX_SIGNATURES = 32


def _warn(msg: str, **fields) -> None:
    # lazy: obs/__init__ imports this module
    from paddlebox_tpu_torch.obs import log as obs_log
    obs_log.warning(msg, **fields)


class _Settings:
    """The plane's switches, set by ``configure``."""

    def __init__(self, flags: ObsFlags) -> None:
        self.enabled = bool(flags.device_obs)
        self.recompile_warmup = int(flags.device_recompile_warmup)
        self.donation_min_bytes = int(flags.device_donation_min_bytes)
        self.leak_windows = int(flags.device_leak_windows)
        self.leak_min_bytes = int(flags.device_leak_min_bytes)


_SETTINGS = _Settings(ObsFlags())


def configure(flags: ObsFlags) -> None:
    """Take the device_* switches of ``flags`` (the last trainer built
    sets them, as it sets the active quality plane)."""
    global _SETTINGS
    _SETTINGS = _Settings(flags)


# ------------------------------------------------------------ the monitor

class _StepEntry:
    """One instrumented entry point's record, mutated under its wrapper's
    lock."""

    def __init__(self, name: str, audit: bool) -> None:
        self.name = name
        self.audit = audit
        self.compiles = 0
        self.compile_ms_total = 0.0
        self.last_compile_ms = 0.0
        self.steady_recompiles = 0
        self.recompile_flagged = False
        self.donation_checks = 0
        self.donation_misses = 0
        self.donation_flagged = False
        self.donation_supported: Any = bool(audit)
        self.donated_bytes = 0
        self.signatures = 0

    def snapshot(self) -> dict:
        d = {"compiles": self.compiles,
             "compile_ms": round(self.compile_ms_total, 3),
             "last_compile_ms": round(self.last_compile_ms, 3),
             "signatures": self.signatures,
             "steady_recompiles": self.steady_recompiles,
             "recompile_flagged": self.recompile_flagged,
             "donate_argnums": [0] if self.audit else []}
        if self.audit:
            d["donation"] = {"checks": self.donation_checks,
                             "misses": self.donation_misses,
                             "supported": self.donation_supported,
                             "donated_bytes": self.donated_bytes}
        return d


def _tensor_type():
    """torch.Tensor, imported here: the serving plane imports the obs
    package and must not load torch (nothing it holds is a tensor)."""
    import torch
    return torch.Tensor


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors of a tensor, a dict, a list or tuple of them, or any
    iterable of them (a parameter generator)."""
    tensor = _tensor_type()
    out: List[torch.Tensor] = []
    stack = [obj]
    while stack:
        x = stack.pop()
        if isinstance(x, tensor):
            out.append(x)
        elif isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif x is not None and hasattr(x, "__iter__") \
                and not isinstance(x, (str, bytes, np.ndarray)):
            stack.extend(list(x))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.element_size() * t.numel()


class DeviceMonitor:
    """The process's instrumented entry points, ledger owners and the
    ledger's state. Reentrant lock: the flight recorder's seal may call
    ``snapshot`` from a handler that interrupted this thread in here."""

    def __init__(self) -> None:
        self._lock = make_rlock("DeviceMonitor._lock")
        self._entries: Dict[str, _StepEntry] = {}
        self._owners: Dict[str, Callable[[], Any]] = {}
        self._ledger: Optional[dict] = None
        self._growth_streak = 0
        self._streak_base = 0
        self._prev_total: Optional[int] = None
        self._kinds: Dict[str, Dict[str, int]] = {"h2d": {}, "d2h": {}}

    def register(self, entry: _StepEntry) -> None:
        """A new wrapper replaces the entry of its name."""
        with self._lock:
            self._entries[entry.name] = entry

    @property
    def active(self) -> bool:
        with self._lock:
            return bool(self._entries or self._owners)

    def register_owner(self, name: str, getter: Callable[[], Any]) -> None:
        """``getter()`` returns the owner's tensors (a tensor, a dict or
        an iterable of them) or None; it must hold its trainer weakly."""
        with self._lock:
            self._owners[name] = getter

    def note_transfer(self, way: str, kind: str, n: int) -> None:
        with self._lock:
            d = self._kinds[way]
            d[kind] = d.get(kind, 0) + n

    def transfer_kinds(self) -> Dict[str, Dict[str, int]]:
        with self._lock:
            return {w: dict(d) for w, d in self._kinds.items()}

    # --------------------------------------------------------------- ledger
    def sample_ledger(self) -> Optional[dict]:
        """Each owner's bytes, ``other``, the total and the peak into the
        gauges, then the leak detector. None when the plane is off."""
        if not _SETTINGS.enabled:
            return None
        with self._lock:
            owners = dict(self._owners)
        buckets: Dict[str, int] = {name: 0 for name in owners}
        seen = set()
        count = 0
        cuda_dev = None
        for name, getter in owners.items():
            try:
                tree = getter()
            except Exception:  # noqa: BLE001 (a dead trainer's getter)
                continue
            for t in _tensors(tree):
                key = (t.data_ptr(), _nbytes(t))
                if key in seen:
                    continue
                seen.add(key)
                count += 1
                buckets[name] += _nbytes(t)
                if t.is_cuda and cuda_dev is None:
                    cuda_dev = t.device
        owned = sum(buckets.values())
        peak = None
        if cuda_dev is not None:
            import torch
            allocated = int(torch.cuda.memory_allocated(cuda_dev))
            buckets["other"] = max(0, allocated - owned)
            total = allocated if allocated > owned else owned
            peak = int(torch.cuda.memory_stats(cuda_dev).get(
                "allocated_bytes.all.peak", 0))
        else:
            buckets["other"] = 0
            total = owned
        sample = {"ts": time.time(), "total_bytes": total, "arrays": count,
                  "owners": buckets}
        gauge_set("device_live_bytes_total", float(total))
        gauge_set("device_live_arrays", float(count))
        for name, nb in buckets.items():
            gauge_set("device_live_bytes_" + name, float(nb))
        if peak is not None:
            sample["peak_bytes"] = peak
            gauge_set("device_live_bytes_peak", float(peak))
        self._leak_check(total, sample)
        with self._lock:
            self._ledger = sample
        return sample

    def _leak_check(self, total: int, sample: dict) -> None:
        windows = _SETTINGS.leak_windows
        min_bytes = _SETTINGS.leak_min_bytes
        fire = False
        with self._lock:
            prev = self._prev_total
            self._prev_total = total
            if prev is None or total <= prev:
                self._growth_streak = 0
                self._streak_base = total
            else:
                if self._growth_streak == 0:
                    self._streak_base = prev
                self._growth_streak += 1
                if (self._growth_streak >= windows
                        and total - self._streak_base >= min_bytes):
                    fire = True
                    grew = total - self._streak_base
                    streak = self._growth_streak
                    # one alarm a sustained climb
                    self._growth_streak = 0
                    self._streak_base = total
        if fire:
            stat_add("device_leak_suspect", 1)
            sample["leak_suspect"] = True
            _warn("device live-buffer ledger: monotonic growth, possible "
                  "leaked device tensor", windows=streak, grew_bytes=grew,
                  total_bytes=total)

    # ------------------------------------------------------------- snapshot
    def snapshot(self) -> dict:
        with self._lock:
            entries = {n: e.snapshot() for n, e in self._entries.items()}
            ledger = dict(self._ledger) if self._ledger else None
        # stat_peek: a fatal-signal seal may have interrupted stat_add
        return {
            "type": "device_plane", "v": SCHEMA_VERSION,
            "active": bool(entries or ledger),
            "entries": entries,
            "transfers": {
                "h2d_bytes": stat_peek("device_transfer_bytes_h2d"),
                "d2h_bytes": stat_peek("device_transfer_bytes_d2h"),
            },
            "recompiles": stat_peek("device_recompiles"),
            "donation_miss": stat_peek("donation_miss"),
            "leak_suspect": stat_peek("device_leak_suspect"),
            "ledger": ledger,
        }

    def reset(self) -> None:
        """Forget entries, owners, the ledger and the transfer kinds (the
        StatRegistry is reset apart)."""
        with self._lock:
            self._entries.clear()
            self._owners.clear()
            self._ledger = None
            self._growth_streak = 0
            self._streak_base = 0
            self._prev_total = None
            self._kinds = {"h2d": {}, "d2h": {}}


_MONITOR = DeviceMonitor()


def monitor() -> DeviceMonitor:
    return _MONITOR


def snapshot() -> dict:
    return _MONITOR.snapshot()


def register_owner(name: str, getter: Callable[[], Any]) -> None:
    _MONITOR.register_owner(name, getter)


def sample_ledger() -> Optional[dict]:
    return _MONITOR.sample_ledger()


def transfer_kinds() -> Dict[str, Dict[str, int]]:
    """Bytes by transfer site since the last reset: {"h2d": {kind: n},
    "d2h": {...}}; their sums are the two counters' growth."""
    return _MONITOR.transfer_kinds()


def on_report() -> None:
    """The StepReport hook: sample the HBM ledger at report cadence."""
    if _SETTINGS.enabled and _MONITOR.active:
        _MONITOR.sample_ledger()


# ----------------------------------------------------------- transfer ledger

def account_h2d(nbytes: int, kind: str = "other") -> None:
    """One host-to-device copy of ``nbytes`` at site ``kind``."""
    n = int(nbytes)
    if n > 0 and _SETTINGS.enabled:
        stat_add("device_transfer_bytes_h2d", n)
        hist_observe("device_h2d_bytes", n)
        _MONITOR.note_transfer("h2d", kind, n)


def account_d2h(nbytes: int, kind: str = "other") -> None:
    """One device-to-host copy of ``nbytes`` at site ``kind``."""
    n = int(nbytes)
    if n > 0 and _SETTINGS.enabled:
        stat_add("device_transfer_bytes_d2h", n)
        hist_observe("device_d2h_bytes", n)
        _MONITOR.note_transfer("d2h", kind, n)


def tree_nbytes(tree) -> int:
    """The bytes of the numpy arrays and tensors in a dict / list / tuple
    tree (host ints count nothing)."""
    tensor = _tensor_type()
    total = 0
    stack = [tree]
    while stack:
        x = stack.pop()
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
        elif isinstance(x, tensor):
            total += _nbytes(x)
        elif isinstance(x, np.ndarray):
            total += int(x.nbytes)
    return total


# ----------------------------------------------------------- instrument_step

def _sig(x):
    """The signature of one argument: tensors and arrays by shape, dtype
    (and a tensor's device type), containers by their structure, anything
    else by its type."""
    if isinstance(x, _tensor_type()):
        return ("T", tuple(x.shape), x.dtype, x.device.type)
    if isinstance(x, np.ndarray):
        return ("N", x.shape, x.dtype.str)
    if isinstance(x, dict):
        return ("D", tuple((k, _sig(v)) for k, v in sorted(x.items())))
    if isinstance(x, (list, tuple)):
        return ("L", type(x).__name__, tuple(_sig(v) for v in x))
    return ("S", type(x).__name__)


class InstrumentedStep:
    """A step entry point with the device plane attached: the same call
    and results as ``fn``."""

    def __init__(self, fn: Callable, name: str,
                 slab_of: Optional[Callable[[], Optional[torch.Tensor]]]
                 = None, slab_argnum: int = 0,
                 recompile_warmup: Optional[int] = None) -> None:
        self._fn = fn
        self.name = str(name)
        self._slab_of = slab_of
        self._slab_argnum = int(slab_argnum)
        self._warmup = recompile_warmup
        self._entry = _StepEntry(self.name, slab_of is not None)
        self._lock = make_lock("InstrumentedJit._lock")
        self._cache: "OrderedDict[Any, bool]" = OrderedDict()
        self._last_missed: Dict[Any, bool] = {}
        _MONITOR.register(self._entry)

    @property
    def __wrapped__(self):
        return self._fn

    def _new_signature(self, key, dt_ms: float) -> None:
        e = self._entry
        warmup = (self._warmup if self._warmup is not None
                  else _SETTINGS.recompile_warmup)
        with self._lock:
            self._cache[key] = True
            while len(self._cache) > MAX_SIGNATURES:
                old, _ = self._cache.popitem(last=False)
                self._last_missed.pop(old, None)
            e.compiles += 1
            e.compile_ms_total += dt_ms
            e.last_compile_ms = dt_ms
            e.signatures = len(self._cache)
            steady = e.compiles > max(warmup, 1)
            if steady:
                e.steady_recompiles += 1
            flag_now = steady and not e.recompile_flagged
            if flag_now:
                e.recompile_flagged = True
        hist_observe("device_compile_ms", dt_ms)
        if steady:
            stat_add("device_recompiles", 1)
        if flag_now:
            _warn("device recompile sentinel: a new step signature past "
                  "warmup (shape/dtype churn; on the card a new kernel "
                  "grid and a CUDA-graph recapture)", fn=self.name,
                  compiles=e.compiles, warmup=warmup)

    def _audit(self, key, ptr: int, nbytes: int) -> None:
        e = self._entry
        after = self._slab_of()
        missed = after is None or after.data_ptr() != ptr
        with self._lock:
            e.donation_checks += 1
            e.donated_bytes = nbytes
            counted = missed and self._last_missed.get(key, False)
            self._last_missed[key] = missed
            if counted:
                e.donation_misses += 1
            flag_now = counted and not e.donation_flagged
            if flag_now:
                e.donation_flagged = True
        if counted:
            stat_add("donation_miss", 1)
        if flag_now:
            _warn("device donation audit: the slab came back at another "
                  "address (copied, not updated in place)", fn=self.name,
                  donated_bytes=nbytes)

    def __call__(self, *args, **kwargs):
        key = (_sig(args), _sig(kwargs))
        with self._lock:
            known = key in self._cache
            if known:
                self._cache.move_to_end(key)
        audit = None
        if self._slab_of is not None and self._slab_argnum < len(args):
            slab = args[self._slab_argnum]
            if isinstance(slab, _tensor_type()):
                nb = _nbytes(slab)
                if nb >= _SETTINGS.donation_min_bytes:
                    audit = (slab.data_ptr(), nb)
        t0 = time.perf_counter()
        out = self._fn(*args, **kwargs)
        if not known:
            self._new_signature(key, (time.perf_counter() - t0) * 1e3)
        if audit is not None:
            self._audit(key, *audit)
        return out


def instrument_step(fn: Callable, name: str,
                    slab_of: Optional[Callable[[], Optional[torch.Tensor]]]
                    = None, slab_argnum: int = 0,
                    recompile_warmup: Optional[int] = None,
                    flags: Optional[ObsFlags] = None) -> Callable:
    """``fn`` with the device plane attached (the reference's
    instrument_jit). ``slab_of`` returns the slab the table holds after a
    call (the audit's other side; None: no audit) and ``slab_argnum`` is
    the slab's position among the arguments. With ``device_obs`` of
    ``flags`` (ObsFlags()) off: ``fn`` itself."""
    if not (flags or ObsFlags()).device_obs:
        return fn
    return InstrumentedStep(fn, name, slab_of=slab_of,
                            slab_argnum=slab_argnum,
                            recompile_warmup=recompile_warmup)

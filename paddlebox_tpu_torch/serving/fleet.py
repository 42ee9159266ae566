"""Serving fleets: N replica processes over one xbox root, and B boxes of
them (paddlebox_tpu/serving/fleet.py).

Each replica is a whole ServingServer (its pull pool, cache and watcher)
in a process of the spawn context: the parent may be a trainer with a CUDA
context and live threads, and the serving import loads no torch, so a
replica comes up in about a second and inherits nothing of the parent's
runtime. The replicas map the same view files; the page cache holds the
one copy of the rows.

The reference sets its flag registry in the child. The port passes the
parent's ServingFlags, ObsFlags and ShardFlags (frozen dataclasses, which
pickle) and the overrides by field name; the child applies the overrides
with ``dataclasses.replace``. A name that is no field of the three raises
in the parent, before a process is spawned.

Shutdown drains: the parent asks each replica to drain over its data port
(pulls in flight finish, new ones are refused), then joins the processes.

``ServingFleet`` is one box. ``MultiBoxFleet`` is B boxes x R replicas,
each box's replicas given its shard (index, policy, hot-key file), so each
filters its views to its slice; ``client()`` gives the FleetClient that
routes by the same policy, and ``health()`` is the fleet's /health
section (obs/exporter.py) while the fleet is up.
"""

from __future__ import annotations

import contextlib
import dataclasses
import multiprocessing as mp
import os
import sys
from typing import Dict, List, Optional, Sequence, Tuple

from paddlebox_tpu_torch.config.flags import (ObsFlags, ServingFlags,
                                              ShardFlags)
from paddlebox_tpu_torch.serving.client import FleetClient, ServingClient

#: the flag dataclasses a replica is made with, in ServingServer's order
FLAG_OWNERS = (ServingFlags, ObsFlags, ShardFlags)


def split_overrides(overrides: Optional[Dict[str, object]]
                    ) -> Dict[str, Dict[str, object]]:
    """``{name: value}`` -> ``{dataclass name: {name: value}}`` over
    FLAG_OWNERS; raises ValueError for a name none of them has."""
    owner = {f.name: cls.__name__ for cls in FLAG_OWNERS
             for f in dataclasses.fields(cls)}
    out: Dict[str, Dict[str, object]] = {c.__name__: {} for c in FLAG_OWNERS}
    for name, value in (overrides or {}).items():
        if name not in owner:
            raise ValueError(
                "unknown serving flag override %r: not a field of %s"
                % (name, ", ".join(c.__name__ for c in FLAG_OWNERS)))
        out[owner[name]][name] = value
    return out


@contextlib.contextmanager
def _spawn_safe_main():
    """Spawn re-runs the parent's __main__ from its file in every child.
    A main that is no real file (a REPL, a script on stdin) would make
    every child die before its target runs; the target never needs it,
    so while spawning a missing __main__.__file__ is hidden and
    multiprocessing skips the re-import."""
    main = sys.modules.get("__main__")
    mf = getattr(main, "__file__", None)
    patch = mf is not None and not os.path.exists(mf)
    if patch:
        del main.__file__
    try:
        yield
    finally:
        if patch:
            main.__file__ = mf


def _serve_child(root: str, days: Optional[Sequence[str]], host: str,
                 conn, base_flags: Tuple, overrides: Dict[str, Dict],
                 rank: int) -> None:
    """A replica (module level, so spawn can pickle it): build the
    server, send its port, then wait for the parent to close the pipe and
    drain."""
    os.environ.setdefault("PBTPU_RANK", str(rank))
    serving, obs, shard = (dataclasses.replace(f, **overrides[
        type(f).__name__]) for f in base_flags)
    from paddlebox_tpu_torch.serving.server import ServingServer
    try:
        server = ServingServer(root, days=days, host=host, flags=serving,
                               obs_flags=obs, shard_flags=shard)
    except BaseException as e:
        conn.send(("error", repr(e)))
        raise
    conn.send(("port", server.port))
    try:
        conn.recv()                  # the parent closes its end at close
    except EOFError:
        pass
    server.drain()


class ServingFleet:
    """Spawn and address N serving replicas on this box."""

    def __init__(self, xbox_model_dir: str,
                 days: Optional[Sequence[str]] = None,
                 processes: int = 2, host: str = "127.0.0.1",
                 flag_overrides: Optional[Dict[str, object]] = None,
                 start_timeout: float = 60.0,
                 rank_base: int = 0,
                 flags: Optional[ServingFlags] = None,
                 obs_flags: Optional[ObsFlags] = None,
                 shard_flags: Optional[ShardFlags] = None) -> None:
        """``flags``, ``obs_flags``, ``shard_flags``: the replicas' base
        (each default made here, from this process's environment);
        ``flag_overrides``: fields of any of them by name. ``rank_base``
        offsets the replicas' PBTPU_RANK (MultiBoxFleet gives box b
        b * replicas)."""
        if processes < 1:
            raise ValueError("need at least one serving process")
        overrides = split_overrides(flag_overrides)
        base = (flags or ServingFlags(), obs_flags or ObsFlags(),
                shard_flags or ShardFlags())
        ctx = mp.get_context("spawn")
        self._procs: List = []
        self._pipes: List = []
        self.endpoints: List[Tuple[str, int]] = []
        try:
            with _spawn_safe_main():
                for rank in range(processes):
                    parent, child = ctx.Pipe()
                    p = ctx.Process(
                        target=_serve_child,
                        args=(xbox_model_dir, list(days) if days else None,
                              host, child, base, overrides,
                              rank_base + rank),
                        daemon=True, name=f"serving-{rank_base + rank}")
                    p.start()
                    child.close()
                    self._procs.append(p)
                    self._pipes.append(parent)
            for rank, parent in enumerate(self._pipes):
                if not parent.poll(start_timeout):
                    raise TimeoutError(
                        f"serving replica {rank} did not come up in "
                        f"{start_timeout}s")
                try:
                    kind, value = parent.recv()
                except EOFError:
                    raise RuntimeError(
                        f"serving replica {rank} died during bring-up "
                        "(its traceback is on stderr)") from None
                if kind != "port":
                    raise RuntimeError(
                        f"serving replica {rank} failed: {value}")
                self.endpoints.append((host, int(value)))
        except BaseException:
            self.close(drain=False)
            raise

    @property
    def pids(self) -> List[int]:
        return [p.pid for p in self._procs]

    def client(self, timeout: float = 30.0) -> ServingClient:
        return ServingClient(self.endpoints, timeout=timeout)

    def close(self, drain: bool = True, join_timeout: float = 30.0) -> None:
        """Drain every replica, then join (``drain=False``: tear down at
        once, the bring-up failure's path)."""
        if drain and self.endpoints:
            c = self.client(timeout=10.0)
            try:
                c.drain_all()
            finally:
                c.close()
        for parent in self._pipes:
            try:
                parent.close()           # ends the child's wait
            except OSError:
                pass
        for p in self._procs:
            p.join(timeout=join_timeout)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5.0)
        self._procs = []
        self._pipes = []

    def __enter__(self) -> "ServingFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class MultiBoxFleet:
    """B boxes x R replicas over one xbox root: box b is a ServingFleet
    whose replicas serve shard b of ``policy_name``'s partition (default
    ``shard_flags.sharding_policy``) and the hot set of
    ``hot_keys_path``."""

    def __init__(self, xbox_model_dir: str,
                 days: Optional[Sequence[str]] = None,
                 boxes: int = 2, replicas: int = 1,
                 host: str = "127.0.0.1",
                 policy_name: Optional[str] = None,
                 hot_keys_path: Optional[str] = None,
                 journal_dirs: Optional[Sequence[str]] = None,
                 flag_overrides: Optional[Dict[str, object]] = None,
                 start_timeout: float = 60.0,
                 flags: Optional[ServingFlags] = None,
                 obs_flags: Optional[ObsFlags] = None,
                 shard_flags: Optional[ShardFlags] = None) -> None:
        if boxes < 1:
            raise ValueError("need at least one box")
        from paddlebox_tpu_torch.obs import exporter
        from paddlebox_tpu_torch.parallel.sharding import \
            resolve_sharding_policy
        from paddlebox_tpu_torch.serving.store import read_hot_keys
        shard_flags = shard_flags or ShardFlags()
        # the client's policy first: a wrong name fails before B x R spawns
        self.policy = resolve_sharding_policy(boxes, name=policy_name,
                                              flags=shard_flags)
        self.hot_keys = (read_hot_keys(hot_keys_path)
                         if hot_keys_path else None)
        base = dict(flag_overrides or {})
        self.boxes: List[ServingFleet] = []
        try:
            for b in range(boxes):
                ov = dict(base)
                ov["serving_shard_index"] = b
                ov["serving_num_shards"] = boxes
                if policy_name:
                    ov["serving_shard_policy"] = policy_name
                if hot_keys_path:
                    ov["serving_hot_keys"] = hot_keys_path
                if journal_dirs:
                    ov["serving_journal_dir"] = ",".join(journal_dirs)
                self.boxes.append(ServingFleet(
                    xbox_model_dir, days=days, processes=replicas,
                    host=host, flag_overrides=ov,
                    start_timeout=start_timeout,
                    rank_base=b * replicas, flags=flags,
                    obs_flags=obs_flags, shard_flags=shard_flags))
        except BaseException:
            self.close(drain=False)
            raise
        self._health_client = self.client(timeout=5.0)
        self._health_client.fleet_stats()    # the QPS delta's base
        exporter.set_fleet_health_provider(self.health)

    @property
    def shard_endpoints(self) -> List[List[Tuple[str, int]]]:
        return [list(b.endpoints) for b in self.boxes]

    def client(self, timeout: float = 30.0,
               coalesce: bool = True) -> FleetClient:
        return FleetClient(self.shard_endpoints, policy=self.policy,
                           hot_keys=self.hot_keys, timeout=timeout,
                           coalesce=coalesce)

    def health(self) -> Dict[str, object]:
        """The fleet's record for /health: fleet_stats (QPS, the merged
        p50 and p99, the watermark and freshness), the policy and the hot
        set's size."""
        st = self._health_client.fleet_stats()
        st["type"] = "serving_fleet"
        st["policy"] = self.policy.describe()
        st["hot_rows"] = int(self.hot_keys.size) \
            if self.hot_keys is not None else 0
        return st

    def close(self, drain: bool = True,
              join_timeout: float = 30.0) -> None:
        from paddlebox_tpu_torch.obs import exporter
        exporter.set_fleet_health_provider(None)
        hc = getattr(self, "_health_client", None)
        if hc is not None:
            hc.close()
            self._health_client = None
        for b in self.boxes:
            b.close(drain=drain, join_timeout=join_timeout)
        self.boxes = []

    def __enter__(self) -> "MultiBoxFleet":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

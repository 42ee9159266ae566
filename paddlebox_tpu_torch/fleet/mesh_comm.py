"""The per-step host exchange: one lockstep all-to-all of numpy arrays.

Counterpart of paddlebox_tpu/fleet/mesh_comm.py's contract
(``MeshComm.exchange``, :85-96, :408-488): rank r hands ``exchange`` one
part for every rank and gets back the part every rank addressed to it, so
rank r ships each peer only that peer's slice (the reference's p2p
traffic pattern). The reference runs its own socket mesh, rendezvoused
through its KV store; the port rides torch.distributed instead: two
``all_to_all_single`` calls on a gloo group of the mesh's own (the sizes
and shapes first, then the payload's bytes), so the stager thread's
exchanges never interleave with the fleet's host collectives on another
group.

Exchanges are LOCKSTEP: every rank calls exchange() the same number of
times in the same order, from one thread (the sharded trainer's stager).
A peer that never arrives fails the call at the group's timeout.
"""

from __future__ import annotations

import time
from typing import Dict, List, Mapping, Optional

import numpy as np
import torch
import torch.distributed as dist

from paddlebox_tpu_torch.obs.tracer import record_span
from paddlebox_tpu_torch.obs.watchdog import beat
from paddlebox_tpu_torch.utils.stats import hist_observe

# the dtypes a part may have, by their code in the header
DTYPES = (np.bool_, np.int8, np.uint8, np.int16, np.uint16, np.int32,
          np.uint32, np.int64, np.uint64, np.float16, np.float32,
          np.float64)
MAX_NDIM = 5
HEADER = 3 + MAX_NDIM   # nbytes, dtype code, ndim, dims


class MeshConnectError(ConnectionError):
    """The exchange's gloo group could not be made at bring-up
    (Fleet.make_mesh_comm). The reference raises it when a peer's socket
    cannot be dialed and falls back to its store funnel; the port has one
    host plane, so it is raised to the caller."""


class MeshPolicyMismatch(RuntimeError):
    """Ranks built their meshes under different sharding policies: they
    would route the same key to different owners."""


def resolve_hostplane(flags=None) -> str:
    """The validated ``hostplane`` of a ShardFlags (None: ShardFlags(),
    from the environment), lower-cased: 'p2p' or 'store'. Both mean the
    one gloo exchange of this module (ROADMAP.md C, one host plane)."""
    if flags is None:
        from paddlebox_tpu_torch.config.flags import ShardFlags
        flags = ShardFlags()
    return str(flags.hostplane).strip().lower()


def _dtype_code(dt: np.dtype) -> int:
    for i, t in enumerate(DTYPES):
        if dt == np.dtype(t):
            return i
    raise TypeError("exchange part of unsupported dtype %s" % dt)


def header(a: np.ndarray) -> List[int]:
    """[nbytes, dtype code, ndim, dims padded to MAX_NDIM] of a part."""
    if a.ndim > MAX_NDIM:
        raise ValueError("exchange part of %d dims (at most %d)"
                         % (a.ndim, MAX_NDIM))
    dims = list(a.shape) + [0] * (MAX_NDIM - a.ndim)
    return [a.nbytes, _dtype_code(a.dtype), a.ndim] + dims


class MeshComm:
    """One rank's end of the lockstep exchange over ``group`` (a gloo
    group whose members are the fleet's ranks 0..world-1).
    ``positions_of`` maps each rank to the mesh positions (shards) it
    owns: rank r owns [r], the port's one topology."""

    def __init__(self, rank: int, world: int, group=None,
                 positions_of: Optional[Dict[int, List[int]]] = None
                 ) -> None:
        self.rank = int(rank)
        self.world = int(world)
        self.group = group
        self.positions_of = (dict(positions_of) if positions_of is not None
                             else {r: [r] for r in range(self.world)})
        self.bytes_sent = 0
        self.bytes_recv = 0
        self.exchange_ms = 0.0
        self.exchanges = 0

    def rank_of_position(self) -> Dict[int, int]:
        """mesh position -> the rank that owns it."""
        return {p: r for r, ps in self.positions_of.items() for p in ps}

    def exchange(self, parts: Mapping[int, np.ndarray]
                 ) -> Dict[int, np.ndarray]:
        """One lockstep all-to-all: parts[r] goes to rank r; returns {r:
        the array rank r addressed to this rank}, each a fresh array with
        its dtype and shape."""
        if set(parts) != set(range(self.world)):
            raise ValueError("exchange needs one part per rank 0..%d, got "
                             "%s" % (self.world - 1, sorted(parts)))
        t0 = time.perf_counter()
        arrs = [np.ascontiguousarray(parts[r]) for r in range(self.world)]
        head = torch.tensor([header(a) for a in arrs], dtype=torch.int64)
        head_in = torch.empty_like(head)
        dist.all_to_all_single(head_in, head, group=self.group)
        send_sizes = [a.nbytes for a in arrs]
        heads = head_in.numpy()
        recv_sizes = [int(h[0]) for h in heads]
        payload = torch.from_numpy(np.concatenate(
            [a.reshape(-1).view(np.uint8) for a in arrs])
            if sum(send_sizes) else np.empty(0, np.uint8))
        got = torch.empty(sum(recv_sizes), dtype=torch.uint8)
        dist.all_to_all_single(got, payload, output_split_sizes=recv_sizes,
                               input_split_sizes=send_sizes,
                               group=self.group)
        raw = got.numpy()
        out: Dict[int, np.ndarray] = {}
        off = 0
        for r, h in enumerate(heads):
            n, code, ndim = int(h[0]), int(h[1]), int(h[2])
            shape = tuple(int(d) for d in h[3:3 + ndim])
            out[r] = raw[off:off + n].view(DTYPES[code]).reshape(shape)
            off += n
        t1 = time.perf_counter()
        self.bytes_sent += sum(send_sizes) - send_sizes[self.rank]
        self.bytes_recv += sum(recv_sizes) - recv_sizes[self.rank]
        self.exchange_ms += (t1 - t0) * 1e3
        self.exchanges += 1
        record_span("mesh_exchange", t0, t1)
        hist_observe("mesh_exchange_us", (t1 - t0) * 1e6)
        beat("mesh_exchange")
        return out

    def stats(self) -> Dict[str, float]:
        """Bytes sent to and received from the peers, and the exchanges'
        host milliseconds, since construction."""
        return {"exchanges": self.exchanges, "bytes_sent": self.bytes_sent,
                "bytes_recv": self.bytes_recv,
                "exchange_ms": round(self.exchange_ms, 3)}

    def close(self) -> None:
        """The group goes with the process group (Fleet.stop)."""
        self.group = None

"""Staged scan chunks, and their pinned asynchronous host-to-device copies.

The role of the reference's MiniBatchGpuPack pinned stacking
(data_feed.h:519-680, cited at paddlebox_tpu/train/trainer.py:130-132) for
the port's chunk driver (train/trainer.py ``run_scan_chunks``):

  HostChunk    one chunk's host staging: each batch's arrays and host ints
               as ``BoxTrainer.host_batch`` gives them, and in the
               chunk-synchronous mode the chunk's push dedup over its flat
               C*K occurrences (``cpush``)
  DeviceChunk  the same on the trainer's device: ``stacked`` holds [C, ...]
               leaves whose row c is batch c (and each host int as a list
               of C), ``cpush`` the chunk's push leaves; on the card also
               the event that the chunk's copy records, and the release the
               consumer calls once the chunk's steps are queued
  PinnedRing   slots of preallocated pinned host buffers and device
               buffers, each for a group of G chunks (StageFlags.
               h2d_stack_chunks), and one copy stream

On the card a group is written straight into a free slot's pinned buffers
(one ``np.stack`` a leaf and chunk), then copied by ONE ``non_blocking``
copy a leaf on the copy stream, behind which the slot's ``copied`` event is
recorded. The compute stream waits on that event before the chunk's first
step. The consumer hands a slot back once the steps of its last chunk are
queued, recording the slot's ``released`` event on the compute stream: the
next copy into the slot's device buffers waits on it, and its pinned
buffers are rewritten only after ``copied`` has completed on the host (a
pinned buffer overwritten before its copy lands would corrupt the batch
silently). Device buffers are allocated once, on the compute stream, and
reused, so no allocation crosses streams. Pinned buffers are allocated once
a ring (never a ``pin_memory()`` a batch); an allocation that fails raises.
On the CPU the staged arrays become tensors with no copy.

Each group's copies go into the device plane's transfer ledger
(obs/device.py ``account_h2d``, kind "staging"); on the CPU the stacked
leaves are counted as the card's copies would be.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from paddlebox_tpu_torch.obs.device import account_h2d
from paddlebox_tpu_torch.utils.lockwatch import make_lock

Host = Dict[str, Union[np.ndarray, int]]
Leaves = Dict[str, Union[torch.Tensor, List[int], int]]
# leaf -> (shape of one chunk's leaf, dtype)
Spec = Dict[str, Tuple[Tuple[int, ...], np.dtype]]


@dataclasses.dataclass
class HostChunk:
    batches: List[Host]
    cpush: Host = dataclasses.field(default_factory=dict)

    def spec(self) -> Spec:
        """Each array leaf's shape and dtype for one chunk: [C, ...] for a
        batch leaf, the array's own shape for a cpush leaf."""
        C = len(self.batches)
        out = {k: ((C,) + v.shape, v.dtype)
               for k, v in self.batches[0].items()
               if isinstance(v, np.ndarray)}
        out.update({k: (v.shape, v.dtype) for k, v in self.cpush.items()
                    if isinstance(v, np.ndarray)})
        return out

    def ints(self) -> Tuple[Leaves, Leaves]:
        """(each batch int as a list of C, the cpush ints)."""
        b0 = self.batches[0]
        per = {k: [b[k] for b in self.batches] for k, v in b0.items()
               if not isinstance(v, np.ndarray)}
        return per, {k: v for k, v in self.cpush.items()
                     if not isinstance(v, np.ndarray)}

    def stack_into(self, k: str, out: np.ndarray) -> None:
        """Leaf ``k`` of this chunk into ``out`` (its spec shape)."""
        if k in self.cpush:
            out[...] = self.cpush[k]
        else:
            np.stack([b[k] for b in self.batches], out=out)


@dataclasses.dataclass
class DeviceChunk:
    stacked: Leaves
    cpush: Leaves
    ready: Optional[torch.cuda.Event] = None
    release: Optional[Callable[[], None]] = None


def to_cpu(host: HostChunk) -> DeviceChunk:
    """The chunk as CPU tensors: each stacked leaf one np.stack, no copy
    to a device."""
    per, cints = host.ints()
    stacked: Leaves = {k: torch.from_numpy(np.stack([b[k]
                                                     for b in host.batches]))
                       for k in host.spec() if k not in host.cpush}
    stacked.update(per)
    cpush: Leaves = {k: torch.from_numpy(v) for k, v in host.cpush.items()
                     if isinstance(v, np.ndarray)}
    account_h2d(sum(t.element_size() * t.numel()
                    for t in (*stacked.values(), *cpush.values())
                    if isinstance(t, torch.Tensor)), "staging")
    cpush.update(cints)
    return DeviceChunk(stacked, cpush)


class _Slot:
    """Pinned host buffers and device buffers for ``group`` chunks, and the
    slot's two events."""

    def __init__(self, spec: Spec, group: int, device: torch.device,
                 compute: torch.cuda.Stream) -> None:
        self.host: Dict[str, torch.Tensor] = {}
        self.dev: Dict[str, torch.Tensor] = {}
        with torch.cuda.stream(compute):
            for k, (shape, dtype) in spec.items():
                tdtype = torch.from_numpy(np.empty(0, dtype)).dtype
                self.host[k] = torch.empty((group,) + shape, dtype=tdtype,
                                           pin_memory=True)
                self.dev[k] = torch.empty((group,) + shape, dtype=tdtype,
                                          device=device)
        self.host_np = {k: t.numpy() for k, t in self.host.items()}
        self.copied = torch.cuda.Event()
        self.released = torch.cuda.Event()


class PinnedRing:
    """``slots`` slots of ``group`` chunks each, allocated at the first
    chunk (the leaves' spec comes from it) and reused while the spec
    holds. ``compute`` is the stream the chunks' steps run on.

    A producer takes a free slot for each group; the ring holds as many
    slots as can be in use at once (the group being consumed, the groups
    staged ahead, the group being staged), so taking one never waits, and
    a ring with no free slot raises."""

    def __init__(self, group: int, slots: int, device: torch.device,
                 compute: torch.cuda.Stream) -> None:
        self.group = group
        self.n_slots = slots
        self.device = device
        self.compute = compute
        self.copy_stream = torch.cuda.Stream(device)
        self._lock = make_lock("PinnedRing._lock")
        self._spec: Optional[Spec] = None
        self._slots: List[_Slot] = []
        self._free: "collections.deque[int]" = collections.deque()

    def matches(self, group: int, slots: int,
                compute: torch.cuda.Stream) -> bool:
        return (group, slots, compute) == (self.group, self.n_slots,
                                           self.compute)

    def _take(self, spec: Spec) -> int:
        with self._lock:
            if spec != self._spec:
                if len(self._free) != len(self._slots):
                    raise RuntimeError("staging ring: the chunk shapes "
                                       "changed while a slot is in use")
                self.copy_stream.synchronize()
                self._slots = [_Slot(spec, self.group, self.device,
                                     self.compute)
                               for _ in range(self.n_slots)]
                self._free = collections.deque(range(self.n_slots))
                self._spec = spec
            if not self._free:
                raise RuntimeError(
                    "staging ring: no free slot of %d; more chunks are "
                    "staged ahead than the ring holds" % self.n_slots)
            return self._free.popleft()

    def to_device(self, hosts: List[HostChunk]) -> List[DeviceChunk]:
        """Copy up to ``group`` host chunks to the device: one pinned write
        a leaf and chunk, then one asynchronous copy a leaf. Returns the
        chunks' device views; each must be released once its steps are
        queued."""
        if not 0 < len(hosts) <= self.group:
            raise ValueError("%d chunks for a group of %d"
                             % (len(hosts), self.group))
        spec = hosts[0].spec()
        i = self._take(spec)
        slot = self._slots[i]
        slot.copied.synchronize()   # the slot's last copy has landed
        n = len(hosts)
        for k, buf in slot.host_np.items():
            for g, h in enumerate(hosts):
                h.stack_into(k, buf[g])
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.copy_stream):
            self.copy_stream.wait_event(slot.released)
            nbytes = 0
            for k, d in slot.dev.items():
                src = slot.host[k][:n]
                d[:n].copy_(src, non_blocking=True)
                nbytes += src.element_size() * src.numel()
            slot.copied.record(self.copy_stream)
        account_h2d(nbytes, "staging")
        left = [n]

        def release() -> None:
            with self._lock:
                left[0] -= 1
                if left[0] == 0 and i not in self._free:
                    slot.released.record(self.compute)
                    self._free.append(i)

        out = []
        for g, h in enumerate(hosts):
            per, cints = h.ints()
            stacked: Leaves = {k: slot.dev[k][g] for k in spec
                               if k not in h.cpush}
            stacked.update(per)
            cpush: Leaves = {k: slot.dev[k][g] for k in spec if k in h.cpush}
            cpush.update(cints)
            out.append(DeviceChunk(stacked, cpush, slot.copied, release))
        return out

    def reset(self) -> None:
        """Hand back every slot still out (chunks staged but never
        consumed, after an error): the compute stream's queued work is
        what a later copy into them waits for."""
        with self._lock:
            for i in range(len(self._slots)):
                if i not in self._free:
                    self._slots[i].released.record(self.compute)
                    self._free.append(i)

    def close(self) -> None:
        """Wait for every copy in flight, then drop the buffers."""
        self.copy_stream.synchronize()
        with self._lock:
            self._slots, self._free, self._spec = [], collections.deque(), \
                None

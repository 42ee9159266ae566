"""The switches the port reads: the push write and the pass lifecycle.

The JAX package keeps these in a process-wide flag registry
(paddlebox_tpu/config/flags.py: ``push_write``, ``push_block_rows``,
``incremental_pass``, ``preload_promote``). The port passes them as values
to the trainer and the pass table instead, so two trainers in one process
can run different modes side by side.
"""

from __future__ import annotations

import dataclasses

PUSH_WRITES = ("scatter", "blocked")


@dataclasses.dataclass(frozen=True)
class PushFlags:
    """push_write: 'scatter' writes each updated row at its slab id;
    'blocked' buckets the sorted uids into ``push_block_rows``-row blocks
    and places them with the blocked-write kernel."""

    push_write: str = "scatter"
    push_block_rows: int = 1024

    def __post_init__(self):
        if self.push_write not in PUSH_WRITES:
            raise ValueError("push_write must be one of %s, got %r"
                             % (PUSH_WRITES, self.push_write))

    def resolve_push_write(self, capacity: int) -> str:
        """The write mode for a slab of ``capacity`` rows; refuses a block
        size that does not divide the slab (a partial tail block would
        shift its rows' local offsets)."""
        if self.push_write == "blocked":
            block = int(self.push_block_rows)
            if block <= 0 or capacity % block:
                raise ValueError(
                    "push_write=blocked: push_block_rows=%d must be positive "
                    "and divide the pass capacity %d" % (block, capacity))
        return self.push_write


@dataclasses.dataclass(frozen=True)
class PassFlags:
    """incremental_pass: the slab stays resident on the device after
    end_pass; the next begin_pass moves the rows of keys it keeps on the
    device and reads only the new keys from the host store, and end_pass
    writes back only the rows the pass touched. preload_promote: while a
    pass trains, run_preloaded_passes' prefetcher reads the next pass's
    non-resident rows that the host store already holds; it is read only
    there, and only with incremental_pass (a pass trained on its own has
    no next pass loading). Both default on, as in the JAX package."""

    incremental_pass: bool = True
    preload_promote: bool = True

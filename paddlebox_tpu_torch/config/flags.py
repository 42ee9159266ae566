"""The switches the port reads: the push write, the pass lifecycle, the
chunk driver's staging, the checkpoint plane and the dtype diet.

The JAX package keeps these in a process-wide flag registry
(paddlebox_tpu/config/flags.py: ``push_write``, ``push_block_rows``,
``incremental_pass``, ``preload_promote``, ``stack_threads``,
``chunk_prefetch_depth``, ``h2d_stack_chunks``, ``ckpt_*``,
``slab_embed_dtype``, ``matmul_dtype``). The port passes
them as values to the trainer, the pass table and the checkpoint manager
instead, so two trainers in one process can run different modes side by
side.
"""

from __future__ import annotations

import dataclasses

PUSH_WRITES = ("scatter", "blocked")
DTYPES = ("float32", "bfloat16")


@dataclasses.dataclass(frozen=True)
class DtypeFlags:
    """The dtype diet (paddlebox_tpu/config/flags.py:229, 257).
    slab_embed_dtype: the device slab's storage, 'float32' or 'bfloat16'
    (embedding/accessor.py: bf16 weights, the other columns as lossless
    (hi, lo) halves; host stores, checkpoints and the push and pull math
    stay f32). matmul_dtype: the dense matmuls' operands, 'bfloat16'
    (rounded to bf16, products summed in f32, an f32 result) or
    'float32'. The trainer reads both at construction."""

    slab_embed_dtype: str = "float32"
    matmul_dtype: str = "float32"

    def __post_init__(self):
        for name in ("slab_embed_dtype", "matmul_dtype"):
            if getattr(self, name) not in DTYPES:
                raise ValueError("%s must be one of %s, got %r"
                                 % (name, DTYPES, getattr(self, name)))


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


@dataclasses.dataclass(frozen=True)
class StageFlags:
    """The chunk driver's host staging (paddlebox_tpu/config/flags.py:
    137-177). stack_threads: threads that stage the batches of a chunk
    (route lookup and dedup), in batch order; 1 or less stages on the
    calling thread. chunk_prefetch_depth: chunks staged ahead on a producer
    thread while the device trains; 0 stages each chunk between two
    dispatches. h2d_stack_chunks: chunks whose staged arrays share one
    host-to-device copy a leaf. The trainer reads them at the start of
    every pass."""

    stack_threads: int = 4
    chunk_prefetch_depth: int = 1
    h2d_stack_chunks: int = 1

    def __post_init__(self):
        for name in ("stack_threads", "chunk_prefetch_depth",
                     "h2d_stack_chunks"):
            if not isinstance(getattr(self, name), int):
                raise TypeError("%s must be an int, got %r"
                                % (name, getattr(self, name)))
        if self.chunk_prefetch_depth < 0 or self.h2d_stack_chunks < 1:
            raise ValueError("chunk_prefetch_depth must be >= 0 and "
                             "h2d_stack_chunks >= 1, got %d and %d"
                             % (self.chunk_prefetch_depth,
                                self.h2d_stack_chunks))


CKPT_FORMATS = ("columnar", "pickle")


@dataclasses.dataclass(frozen=True)
class CkptFlags:
    """The checkpoint plane's switches (the JAX package's ckpt_* flags,
    paddlebox_tpu/config/flags.py:455-500), passed by value to the stores'
    save, PassTable.save and CheckpointManager.

    ckpt_format: the sparse batch tier as a 'columnar' manifest with
    ``ckpt_parts`` striped part files, written and read by a pool of
    ``ckpt_io_threads`` threads (0: one a part, up to the cores and 16), or
    as one legacy 'pickle'; either loads whatever this says.
    ckpt_xbox_columnar: xbox views as the serving columnar file
    (view.xcol), else the legacy embedding.pkl. ckpt_journal: the
    touched-row journal (train/journal.py) under
    ``<batch_model_dir>/_journal/rank0``, which save_base(mode='touched' or
    'auto') and per-pass recovery ride; its segments rotate at
    ``ckpt_journal_segment_bytes`` and at most ``ckpt_journal_segments``
    stay, past which the oldest is dropped and touched saves fall back to
    full until the next full base."""

    ckpt_format: str = "columnar"
    ckpt_parts: int = 8
    ckpt_io_threads: int = 0
    ckpt_xbox_columnar: bool = True
    ckpt_journal: bool = True
    ckpt_journal_segment_bytes: int = 64 << 20
    ckpt_journal_segments: int = 32

    def __post_init__(self):
        if self.ckpt_format not in CKPT_FORMATS:
            raise ValueError("ckpt_format must be one of %s, got %r"
                             % (CKPT_FORMATS, self.ckpt_format))

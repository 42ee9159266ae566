"""The shapes past the flagship's that the copy kernels are held to.

``gather_edge_cases`` (``ops/row_kernels.gather_rows``),
``blocked_edge_cases`` (``embedding/push_kernels.blocked_write``) and
``scale_edge_cases`` (``ops/row_kernels.scale_copy``): chip_smoke.py holds
each kernel bit-equal to its plain version on them, and
tests/test_torch_row_kernels.py and tests/test_torch_push_kernels.py hold
the plain versions to the JAX functions on the same cases. The 2-byte
forms of the bf16 slab diet have their own (``gather_edge_cases_2byte``,
``blocked_edge_cases_2byte``: odd row widths, whose rows start 4-byte
aligned only on every other row; the placement's consecutive source runs
and tensors one element into their buffers), which
tests/test_torch_bf16.py and chip_smoke.py use alike. Inputs are numpy
arrays made from seeds; 2-byte sources are uint16 bits (as int16 on the
card).
"""

from __future__ import annotations

import numpy as np

# rows a tile of the gather kernel (csrc/gather_rows.cu R; DIRECT_ROWS, a
# block of its direct path for wide rows, is the same)
GATHER_TILE_ROWS = 64
# floats a block of the scale kernel's aligned path (csrc/scale_copy.cu:
# THREADS float4s), and its blocks resident at once on an H100 (132 SMs, 8
# blocks of 256 threads an SM)
SCALE_BLOCK_FLOATS = 256 * 4
SCALE_WAVE_H100 = 132 * 8


def gather_edge_cases() -> dict:
    """The row gather's edge cases, name -> (flat, offset, C, W, ids):
    the source is ``flat[offset:offset + C * W]`` as [C, W] f32, offset 0
    or 1 (one float into the buffer: not 16-byte aligned); ids int32 [K],
    K in {1, R - 1, R + 1, 131071} for the kernel's block of R rows, with
    duplicates and ids past the source (they read row C - 1), for W in
    {1, 17, 32, 33, 128} (32: float4 elements where aligned)."""
    rng = np.random.RandomState(8)
    C, R = 3000, GATHER_TILE_ROWS
    cases = {}
    for W in (1, 17, 32, 33, 128):
        flat = rng.rand(C * W + 1).astype(np.float32)
        for K in (1, R - 1, R + 1, 131071):
            ids = rng.randint(0, C + 40, K).astype(np.int32)
            ids[0] = C + 1000
            for offset in (0, 1):
                cases["K%d_W%d%s" % (K, W, "_offset" if offset else "")] = (
                    flat, offset, C, W, ids)
    return cases


def gather_source(flat, offset: int, C: int, W: int):
    """The [C, W] source view of a case's (numpy or torch) buffer."""
    return flat[offset:offset + C * W].reshape(C, W)


def scale_edge_cases() -> dict:
    """The streaming scale's edge cases, name -> (flat, offset, rows, W):
    x is ``gather_source(flat, offset, rows, W)``, n = rows * W floats at
    byte offset 4 * offset in {0, 4, 8, 12} of the buffer (on the card, 0
    is 16-byte aligned; the others leave the 0-3 floats before the first
    aligned one to the threads, or, against the wrapper's aligned output,
    take the shifted path); n in {1, 3, 4, 5}, a block of the kernel and
    one float either side of it, one block more than an H100 holds at once
    (a second wave), plus 7, and 2^22 + 3. A case is [n // 128, 128] where
    128 divides n, else one row."""
    rng = np.random.RandomState(12)
    T = SCALE_BLOCK_FLOATS
    waves = (SCALE_WAVE_H100 + 1) * T + 7
    cases = {}
    for n in (1, 3, 4, 5, T - 1, T, T + 1, waves, (1 << 22) + 3):
        flat = rng.rand(n + 3).astype(np.float32) * 200 - 100
        W = 128 if n % 128 == 0 else n
        for offset in range(4):
            cases["n%d_byte%d" % (n, 4 * offset)] = (flat, offset, n // W,
                                                     W)
    return cases


def blocked_edge_cases() -> dict:
    """The blocked write's edge cases, name -> (slab [C, W], new_rows
    [U, W], row_map [NB, B], blk_idx [NB], offset), W = 17: placed lanes'
    sources a random permutation (non-consecutive rows of new_rows);
    sentinel slots (every lane -1) clamped onto the last block, ordered
    before that block's real slot, as the Pallas grid needs; a fully placed
    slot; B in {100, 256, 1024, 4096} (100: a tile of the kernel spans
    slots); NB = 1; and no lane placed at all. ``offset`` 1 asks for the
    row map one entry into a larger buffer on the card (not 16-byte
    aligned)."""
    rng = np.random.RandomState(9)
    W = 17

    def make(B, NB, n_blocks, density, sentinels=0, full=False, offset=0):
        real = NB - sentinels
        blocks = rng.choice(n_blocks - 1, real, replace=False)
        if sentinels and real:
            blocks[0] = n_blocks - 1
        mask = rng.rand(real, B) < density
        if full:
            mask[-1] = True
        placed = int(mask.sum())
        U = placed + 50
        real_map = np.full((real, B), -1, np.int32)
        real_map[mask] = rng.permutation(U)[:placed]
        row_map = np.concatenate(
            [np.full((sentinels, B), -1, np.int32), real_map])
        blk_idx = np.concatenate(
            [np.full(sentinels, n_blocks - 1), blocks]).astype(np.int32)
        slab = rng.rand(n_blocks * B, W).astype(np.float32)
        new_rows = rng.rand(U, W).astype(np.float32)
        return slab, new_rows, row_map, blk_idx, offset

    return {
        "B1024_permuted_sentinels": make(1024, 24, 64, 0.07, sentinels=6),
        "B256_full_slot": make(256, 12, 32, 0.1, full=True),
        "B4096": make(4096, 6, 12, 0.05),
        "NB1": make(1024, 1, 8, 0.3),
        "B100_offset": make(100, 40, 64, 0.2, sentinels=3, offset=1),
        "none_placed": make(1024, 4, 8, 0.0, sentinels=4),
    }


# the bf16 slab's device widths at embedx 2, 8 and 64 (17 + D), and two
# more widths of the same staged kernel: an even one and one wider than a
# block's 128 threads
WIDTHS_2BYTE = (19, 25, 26, 81, 256)


def gather_edge_cases_2byte() -> dict:
    """The 2-byte row gather's edge cases, name -> (flat, offset, C, W,
    ids): the source is ``flat[offset:offset + C * W]`` as [C, W] uint16
    bits, offset 0 or 1 (one 2-byte element into the buffer: not 4-byte
    aligned); ids int32 [K], K in {1, R - 1, R + 1, 4097} for the kernel's
    tile of R rows, with duplicates, odd ids (odd row starts) and ids past
    the source (they read row C - 1), for W in WIDTHS_2BYTE."""
    rng = np.random.RandomState(18)
    C, R = 3001, GATHER_TILE_ROWS
    cases = {}
    for W in WIDTHS_2BYTE:
        flat = rng.randint(0, 1 << 16, C * W + 1).astype(np.uint16)
        for K in (1, R - 1, R + 1, 4097):
            ids = rng.randint(0, C + 40, K).astype(np.int32)
            ids[0] = C + 1000
            for offset in (0, 1):
                cases["K%d_W%d%s" % (K, W, "_offset" if offset else "")] = (
                    flat, offset, C, W, ids)
    return cases


# the blocked write's 2-byte widths: the bf16 device widths at embedx 2, 8
# and 64, and an even one (every row starts at the slab's own parity)
BLOCKED_WIDTHS_2BYTE = (19, 25, 81)
BLOCKED_EVEN_WIDTH_2BYTE = 26
# the first source row of the consecutive runs that start at an odd row
RUN_ODD_START = 7


def blocked_edge_cases_2byte() -> dict:
    """The 2-byte blocked write's edge cases, name -> (slab [C, W],
    new_rows [U, W] uint16 bits, row_map [NB, B], blk_idx [NB], offset,
    data_offsets), for W 19, 25, 26 and 81 and blocks of B rows odd and even
    (an odd B puts every other block's first row on a 2-byte boundary).

    Permuted sources (any row map: the kernel's general path): sentinel
    slots clamped onto the last block and ordered before its real slot, a
    fully placed slot, NB = 1, nothing placed. Consecutive sources, as
    ``optimizers.blocked_layout`` builds them from sorted uids (the
    kernel's staged run; every flagship tile is one): runs that start at an
    odd source row, that cross slot boundaries inside a tile (B 100 and
    257), a last tile shorter than a tile, a run with one break (a skipped
    source row) and one with two sources swapped (both take the general
    path), and, at W 25 and 26, every pairing of the parities of the
    source and slab rows' first elements: placed lanes on even or on odd
    slab rows only, under each pair of data offsets.

    ``offset`` 1 asks for the row map one entry into a larger buffer on
    the card (not 16-byte aligned); ``data_offsets`` (slab, new_rows) ask
    the same of the slab and of new_rows, 1 placing a tensor one 2-byte
    element into a larger buffer (not 4-byte aligned)."""
    rng = np.random.RandomState(19)

    def make(W, B, NB, n_blocks, density, sentinels=0, full=False,
             offset=0, data_offsets=(0, 0)):
        real = NB - sentinels
        blocks = rng.choice(n_blocks - 1, real, replace=False)
        if sentinels and real:
            blocks[0] = n_blocks - 1
        mask = rng.rand(real, B) < density
        if full:
            mask[-1] = True
        placed = int(mask.sum())
        U = placed + 50
        real_map = np.full((real, B), -1, np.int32)
        real_map[mask] = rng.permutation(U)[:placed]
        row_map = np.concatenate(
            [np.full((sentinels, B), -1, np.int32), real_map])
        blk_idx = np.concatenate(
            [np.full(sentinels, n_blocks - 1), blocks]).astype(np.int32)
        slab = rng.randint(0, 1 << 16, (n_blocks * B, W)).astype(np.uint16)
        new_rows = rng.randint(0, 1 << 16, (U, W)).astype(np.uint16)
        return slab, new_rows, row_map, blk_idx, offset, data_offsets

    def run(W, B, NB, n_blocks, density, start=0, rows=None, fault=None,
            data_offsets=(0, 0)):
        """Ascending blocks, their placed lanes carrying the sources start,
        start + 1, ... in lane order; ``rows`` 0 or 1 keeps only lanes on
        slab rows of that parity (B even); ``fault`` "skip" or "swap"
        breaks the run in the middle of the first tile."""
        blocks = np.sort(rng.choice(n_blocks, NB, replace=False))
        mask = rng.rand(NB, B) < density
        if rows is not None:
            mask[:, 1 - rows::2] = False
        placed = int(mask.sum())
        src = start + np.arange(placed)
        first_tile = int(mask.reshape(-1)[:1024].sum())
        mid = max(first_tile // 2, 1)
        if fault == "skip":
            src[mid:] += 1
        elif fault == "swap":
            src[mid - 1], src[mid] = src[mid], src[mid - 1]
        row_map = np.full((NB, B), -1, np.int32)
        row_map[mask] = src
        U = int(src.max(initial=start)) + 4
        slab = rng.randint(0, 1 << 16, (n_blocks * B, W)).astype(np.uint16)
        new_rows = rng.randint(0, 1 << 16, (U, W)).astype(np.uint16)
        return slab, new_rows, row_map, blocks.astype(np.int32), 0, \
            data_offsets

    def permuted(W):
        return {
            "W%d_B1024_permuted_sentinels" % W: make(W, 1024, 24, 64, 0.07,
                                                     sentinels=6),
            "W%d_B101_full_slot" % W: make(W, 101, 12, 32, 0.1, full=True),
            "W%d_B100_offset" % W: make(W, 100, 40, 64, 0.2, sentinels=3,
                                        offset=1),
            "W%d_B257_NB1" % W: make(W, 257, 1, 8, 0.3),
            "W%d_none_placed" % W: make(W, 128, 4, 8, 0.0, sentinels=4),
        }

    cases = {}
    for W in BLOCKED_WIDTHS_2BYTE:
        cases.update(permuted(W))
    W2 = BLOCKED_EVEN_WIDTH_2BYTE
    cases.update(permuted(W2))
    for W in BLOCKED_WIDTHS_2BYTE + (W2,):
        cases.update({
            "W%d_permuted_data_offsets" % W: make(W, 100, 30, 64, 0.2,
                                                  data_offsets=(0, 1)),
            "W%d_run_B1024_odd_start" % W: run(W, 1024, 6, 16, 0.07,
                                               start=RUN_ODD_START),
            "W%d_run_B100_data_offsets" % W: run(W, 100, 40, 64, 0.2,
                                                 data_offsets=(1, 1)),
            "W%d_run_B257_tail" % W: run(W, 257, 5, 8, 0.3, start=3),
            "W%d_run_skip" % W: run(W, 1024, 4, 8, 0.1, fault="skip"),
            "W%d_run_swap" % W: run(W, 1024, 4, 8, 0.1, fault="swap"),
        })
    for W in (25, W2):
        for rows in (0, 1):
            for offs in ((0, 0), (0, 1), (1, 0), (1, 1)):
                cases["W%d_run_%s_rows_offsets_%d_%d" % (
                    (W, ("even", "odd")[rows]) + offs)] = run(
                        W, 1024, 3, 8, 0.15, start=RUN_ODD_START * rows,
                        rows=rows, data_offsets=offs)
    return cases

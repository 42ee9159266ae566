"""The shapes past the flagship's that the copy kernels are held to.

``gather_edge_cases`` (``ops/row_kernels.gather_rows``),
``blocked_edge_cases`` (``embedding/push_kernels.blocked_write``) and
``scale_edge_cases`` (``ops/row_kernels.scale_copy``): chip_smoke.py holds
each kernel bit-equal to its plain version on them, and
tests/test_torch_row_kernels.py and tests/test_torch_push_kernels.py hold
the plain versions to the JAX functions on the same cases. Inputs are numpy
arrays made from seeds.
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

"""The rate probe's kernels in the port: plain versions against the JAX
probe's Pallas kernels and the JAX pull, wrapper contracts, the probe's
entry point on the CPU, and (on a GPU) each CUDA kernel against its plain
version.

The Pallas kernels run interpreted on the CPU. Every comparison is
bit-equal: the gather is a copy, and the scale rounds x * 0.999 + 0.001
once to f32 on both sides (a fused multiply-add).
"""

import functools
import json
import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from paddlebox_tpu.embedding.accessor import ValueLayout as JLayout
from paddlebox_tpu.ops import sparse as jsparse

from paddlebox_tpu_torch import edge_cases, rate_probe
from paddlebox_tpu_torch.native.kernel_args import use_kernel
from paddlebox_tpu_torch.ops import row_kernels as rk
from paddlebox_tpu_torch.ops import sparse
from paddlebox_tpu_torch.train import flagship

D = 8


@pytest.fixture(scope="module")
def probe():
    """tools/pallas_rate_probe.py, imported on the CPU: it reads its JAX
    platform from sys.argv[1] at import, which under pytest is a path."""
    saved = sys.argv
    sys.argv = ["pallas_rate_probe.py", "cpu"]
    try:
        from tools import pallas_rate_probe
    finally:
        sys.argv = saved
    return pallas_rate_probe


def _bits(a) -> np.ndarray:
    return np.asarray(a).view(np.uint32)


# ---------------------------------------------------------------- scale_copy

def test_plain_scale_matches_pallas_copy_kernel(probe):
    x = np.random.RandomState(0).rand(2048, 128).astype(np.float32)
    block_rows = 1024
    want = pl.pallas_call(
        probe.copy_kernel,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(x.shape[0] // block_rows,),
        in_specs=[pl.BlockSpec((block_rows, x.shape[1]), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((block_rows, x.shape[1]), lambda i: (i, 0)),
        interpret=True)(jnp.asarray(x))
    got = rk.scale_copy(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    # PyTorch's two-op form rounds twice and is not the kernel's function
    twice = (torch.from_numpy(x) * 0.999 + 0.001).numpy()
    assert (_bits(twice) != _bits(want)).any()


def _fma_round_to_odd(x: np.ndarray) -> np.ndarray:
    """x * 0.999f + 0.001f rounded once to f32, exactly: the f64 sum is
    rounded to odd (TwoSum gives its error), and a value rounded to odd
    with 29 spare bits rounds correctly to f32."""
    a, b = rk.SCALE, rk.SHIFT
    p = x.astype(np.float64) * a          # exact
    s = p + b
    bb = s - p
    err = (p - (s - bb)) + (b - bb)
    even = (s.view(np.int64) & 1) == 0
    fix = (err != 0) & even & np.isfinite(err)
    s = np.where(fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)), s)
    return s.astype(np.float32)


def test_plain_scale_rounds_once_over_every_binade():
    # every 4093rd f32 bit pattern (both signs, all exponents, subnormals
    # included), plus 1.5 * 2^e, whose product with 0.999f is an f32 tie
    patterns = np.arange(0, 1 << 32, 4093, dtype=np.uint64).astype(np.uint32)
    x = patterns.view(np.float32)
    ties = np.float32(1.5) * np.float32(2.0) ** np.arange(
        -126, 126, dtype=np.float32)
    x = np.concatenate([x[np.isfinite(x)], ties, -ties])
    got = rk.scale_copy_plain(torch.from_numpy(x)[None, :]).numpy()[0]
    np.testing.assert_array_equal(_bits(got), _bits(_fma_round_to_odd(x)))


SCALE_CASES = edge_cases.scale_edge_cases()


@pytest.mark.parametrize("case", sorted(SCALE_CASES))
def test_plain_scale_edge_cases_round_once(case):
    """n in {1, 3, 4, 5}, around the kernel's block, into a second wave of
    blocks and 2^22 + 3, x 0-12 bytes into its buffer: the wrapper on the
    CPU (the plain version) is the exact single rounding, bit for bit."""
    flat, offset, rows, W = SCALE_CASES[case]
    x = edge_cases.gather_source(flat, offset, rows, W)
    t = torch.from_numpy(x)
    assert t.data_ptr() - torch.from_numpy(flat).data_ptr() == 4 * offset
    got = rk.scale_copy(t).numpy()
    assert got.shape == (rows, W)
    want = _bits(_fma_round_to_odd(x))
    np.testing.assert_array_equal(_bits(got), want)
    np.testing.assert_array_equal(_bits(rk.scale_copy_plain(t).numpy()),
                                  want)


@pytest.mark.parametrize("case", sorted(SCALE_CASES))
def test_plain_scale_edge_cases_match_pallas_copy_kernel(probe, case):
    """The same cases through the Pallas copy_kernel, interpreted, in
    blocks of gcd(rows, 8) rows (every case's row count is a multiple)."""
    flat, offset, rows, W = SCALE_CASES[case]
    x = edge_cases.gather_source(flat, offset, rows, W)
    block_rows = math.gcd(rows, 8)
    want = pl.pallas_call(
        probe.copy_kernel,
        out_shape=jax.ShapeDtypeStruct(x.shape, x.dtype),
        grid=(rows // block_rows,),
        in_specs=[pl.BlockSpec((block_rows, W), lambda i: (i, 0))],
        out_specs=pl.BlockSpec((block_rows, W), lambda i: (i, 0)),
        interpret=True)(jnp.asarray(x))
    np.testing.assert_array_equal(
        _bits(rk.scale_copy(torch.from_numpy(x)).numpy()), _bits(want))


# --------------------------------------------------------------- gather_rows

def test_plain_gather_matches_pallas_gather_kernel(probe):
    rng = np.random.RandomState(0)
    C, K, rps = 4096, 64, 8
    slab = rng.rand(C, 128).astype(np.float32)
    idx = np.sort(rng.choice(C - 1, K, replace=False)).astype(np.int32)
    want = pl.pallas_call(
        functools.partial(probe.gather_kernel, rows_per_step=rps),
        out_shape=jax.ShapeDtypeStruct((K, 128), jnp.float32),
        grid=(K // rps,),
        in_specs=[pl.BlockSpec(memory_space=pl.ANY),
                  pl.BlockSpec(memory_space=pl.ANY)],
        out_specs=pl.BlockSpec((rps, 128), lambda g: (g, 0)),
        interpret=True)(jnp.asarray(idx), jnp.asarray(slab))
    got = rk.gather_rows(torch.from_numpy(slab), torch.from_numpy(idx))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_plain_gather_matches_jax_pull_with_clamp():
    rng = np.random.RandomState(1)
    layout = JLayout(D, "adagrad")
    C = 96
    slab = rng.rand(C, layout.width).astype(np.float32)
    ids = rng.randint(0, 40, 50).astype(np.int32)   # duplicates
    ids[::7] = C - 1                                  # the trash row
    ids[3], ids[11] = C, C + 1000                     # past the slab
    want = jsparse.gather_slab_rows(jnp.asarray(slab), jnp.asarray(ids),
                                    layout)
    s, i = torch.from_numpy(slab), torch.from_numpy(ids)
    np.testing.assert_array_equal(_bits(rk.gather_rows_plain(s, i).numpy()),
                                  _bits(want))
    np.testing.assert_array_equal(_bits(sparse.gather_slab_rows(s, i)
                                        .numpy()), _bits(want))
    np.testing.assert_array_equal(np.asarray(want)[3], slab[C - 1])


GATHER_CASES = edge_cases.gather_edge_cases()


@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_plain_gather_edge_cases_match_jax(case):
    """K around the kernel's tile (1, R - 1, R + 1, 131071) for W in {1,
    17, 33, 128}, ids past the source, a source one float into its buffer:
    the plain version (and the wrapper on the CPU) is JAX's clamped
    slab[ids], bit for bit."""
    flat, offset, C, W, ids = GATHER_CASES[case]
    src = edge_cases.gather_source(flat, offset, C, W)
    want = np.asarray(jnp.asarray(src)[jnp.asarray(ids)])
    s, i = torch.from_numpy(src), torch.from_numpy(ids)
    got = rk.gather_rows_plain(s, i).numpy()
    assert got.shape == (ids.shape[0], W)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(rk.gather_rows(s, i).numpy()),
                                  _bits(want))
    np.testing.assert_array_equal(got[ids >= C], src[np.full(
        int((ids >= C).sum()), C - 1)])


def test_cpu_wrappers_run_plain_without_counting():
    rk.reset_launch_counts()
    x = torch.rand(8, 128)
    assert torch.equal(rk.scale_copy(x), rk.scale_copy_plain(x))
    src = torch.rand(32, 17)
    ids = torch.tensor([0, 31, 31, 5, 40], dtype=torch.int32)
    assert torch.equal(sparse.gather_slab_rows(src, ids),
                       rk.gather_rows_plain(src, ids))
    assert rk.gather_rows(src, ids[:0]).shape == (0, 17)
    assert rk.launch_counts() == {"scale_copy": 0, "gather_rows": 0,
                                  "gather_rows_2byte": 0,
                                  "gather_rows_decode": 0}


def test_wrappers_check_arguments():
    src = torch.rand(16, 17)
    ids = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(TypeError):
        rk.gather_rows(src.double(), ids)
    with pytest.raises(TypeError):
        rk.gather_rows(src, ids.long())
    with pytest.raises(ValueError):
        rk.gather_rows(src[0], ids)
    with pytest.raises(ValueError):
        rk.gather_rows(src.t(), ids)
    with pytest.raises(ValueError):
        rk.gather_rows(src, ids[None, :])
    with pytest.raises(ValueError):
        rk.gather_rows(torch.zeros(0, 17), ids)
    with pytest.raises(ValueError):
        rk.gather_rows(src, ids.to("meta"))
    with pytest.raises(TypeError):
        rk.scale_copy(src.half())
    with pytest.raises(ValueError):
        rk.scale_copy(src.reshape(-1))
    with pytest.raises(ValueError):
        rk.scale_copy(src.t())
    with pytest.raises(TypeError):
        rk.scale_copy(src.numpy())
    with pytest.raises(ValueError):
        use_kernel(torch.device("meta"))


# ---------------------------------------------------------- the rate probe

TINY = rate_probe.ProbeSizes(
    scale_rows=(64, 256), width=128, slab_rows=4096, gather_rows=64,
    pull=flagship.Flagship(num_slots=4, batch=32, max_len=3, hidden=(16, 8),
                           capacity=1024, num_files=2, lines_per_file=96,
                           vocab_per_slot=60, data_seed=7))


def test_rate_probe_cases_on_cpu(capsys):
    records = rate_probe.run(device="cpu", sizes=TINY)
    lines = capsys.readouterr().out.strip().splitlines()
    parsed = [json.loads(line) for line in lines]
    assert parsed[0] == {"device": "cpu", "card": None}
    assert parsed[1:] == records
    assert [r["op"] for r in records] == [
        "kernel_scale_32KB", "torch_scale_32KB", "torch_scale_2op_32KB",
        "kernel_scale_128KB", "torch_scale_128KB", "torch_scale_2op_128KB",
        "kernel_gather_64_rows", "torch_gather_64_rows_W128",
        "kernel_gather_pull_W17", "torch_gather_pull_W17"]
    by_op = {r["op"]: r for r in records}
    # the kernels (here their plain versions) and the gathers are exact;
    # PyTorch's two-op scale rounds twice
    assert all(by_op[op]["bit_equal_to_plain"] for op in (
        "kernel_scale_32KB", "kernel_scale_128KB", "kernel_gather_64_rows",
        "torch_gather_64_rows_W128", "kernel_gather_pull_W17",
        "torch_gather_pull_W17"))
    assert not by_op["torch_scale_2op_32KB"]["bit_equal_to_plain"]
    assert by_op["torch_scale_32KB"]["bytes"] == 2 * 64 * 128 * 4
    # unique ids: each row read once and written once
    assert by_op["kernel_gather_64_rows"]["bytes"] == 64 * (4 + 2 * 128 * 4)
    pull = records[-1]
    _, ids = rate_probe.pull_inputs(TINY.pull)
    K, distinct = ids.shape[0], np.unique(ids).size
    assert K == 32 * 4 * 3 and distinct < K
    assert pull["shape"] == [[1024, 17], [K]]
    assert pull["bytes"] == K * 4 + (distinct + K) * 17 * 4
    # a CPU run measures no device rate
    assert all(r["ms_per_call"] is None and r["share_of_hbm"] is None
               and r["plain_ms"] is None for r in records)


def test_gather_bytes_count_distinct_rows_once():
    ids = np.array([0, 5, 5, 9, 9, 9, 12], np.int32)   # 12 clamps to 9
    assert rate_probe.gather_bytes(ids, 10, 17) == 7 * 4 + (3 + 7) * 17 * 4


def test_rate_probe_inputs_follow_the_tpu_probe():
    xs, slab, ids = rate_probe.probe_inputs(TINY)
    rng = np.random.RandomState(0)
    np.testing.assert_array_equal(xs[0], rng.rand(64, 128).astype(np.float32))
    rng.rand(256, 128)
    np.testing.assert_array_equal(slab,
                                  rng.rand(4096, 128).astype(np.float32))
    assert ids.dtype == np.int32 and ids.shape == (64,)
    assert (np.diff(ids) > 0).all() and ids.max() < 4095
    pull_slab, pull_ids = rate_probe.pull_inputs(TINY.pull)
    assert pull_slab.shape == (1024, 17)
    assert (pull_ids == 1023).any() and (pull_ids < 1023).any()


def test_rate_probe_refuses_to_measure_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        rate_probe.run(sizes=TINY)


def test_scale_balanced_refuses_to_measure_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError):
        rate_probe.scale_balanced(1, sizes=TINY)


# ------------------------------------------------- on the card (cuda mark)

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA kernel has no CPU mode; "
                    "chip_smoke.py holds both kernels against their plain "
                    "versions on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCALE_CASES))
def test_cuda_scale_copy_matches_plain(cuda_device, case):
    """The kernel on the edge cases (a part block, a second wave of
    blocks, the threads' head and tail floats, the shifted path for an x
    that is not 16-byte aligned against the aligned output): one launch,
    bit-equal to its plain version."""
    flat, offset, rows, W = SCALE_CASES[case]
    x = edge_cases.gather_source(torch.from_numpy(flat).to(cuda_device),
                                 offset, rows, W)
    before = rk.scale_copy.launches
    got = rk.scale_copy(x)
    torch.cuda.synchronize()
    assert rk.scale_copy.launches == before + 1
    assert torch.equal(got.view(torch.int32),
                       rk.scale_copy_plain(x).view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(GATHER_CASES))
def test_cuda_gather_rows_matches_plain(cuda_device, case):
    """The kernel on the edge cases (its staged tiles, tails, the direct
    path for wide rows, a source that is not 16-byte aligned): bit-equal
    to its plain version."""
    flat, offset, C, W, ids = GATHER_CASES[case]
    src = edge_cases.gather_source(torch.from_numpy(flat).to(cuda_device),
                                   offset, C, W)
    i = torch.from_numpy(ids).to(cuda_device)
    before = rk.gather_rows.launches
    got = rk.gather_rows(src, i)
    torch.cuda.synchronize()
    assert rk.gather_rows.launches == before + 1
    assert torch.equal(got.view(torch.int32),
                       rk.gather_rows_plain(src, i).view(torch.int32))

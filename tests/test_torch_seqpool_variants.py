"""The seqpool variants of the port against the JAX package's.

cvm_conv_transform, fused_seqpool_cvm_with_conv, _with_credit, _tradew,
_with_diff_thres and _with_pcoc (paddlebox_tpu/ops/seqpool.py:60-205) on
the same seeded arrays, over every flag each takes. The segments are a
packer's: nondecreasing, with a padding tail pinned to the last segment
and marked invalid, some segments empty. Tolerance rtol 1e-6 / atol 1e-6:
the pools add the same f32 values in the same order, and log may differ
in its last bit between the two libraries. An unsorted segment vector,
which the reference's unsorted segment sum would take, is refused.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.ops import seqpool as jsp

from paddlebox_tpu_torch import ops as pops
from paddlebox_tpu_torch.ops import seqpool as psp

B, S, E = 5, 3, 4


def _arrays(width, seed=0):
    """(emb [K, width] f32 >= 0, segments [K] nondecreasing with a padding
    tail on the last segment, valid [K], slots [K])."""
    rng = np.random.RandomState(seed)
    counts = rng.randint(0, 4, B * S)
    segments = np.repeat(np.arange(B * S), counts)
    pad = 7
    segments = np.concatenate([segments, np.full(pad, B * S - 1)])
    K = segments.size
    valid = np.r_[rng.rand(K - pad) < 0.85, np.zeros(pad, bool)]
    emb = (rng.rand(K, width) * 3).astype(np.float32)
    emb[~valid] = 0.0
    return emb, segments.astype(np.int32), valid, (segments % S).astype(
        np.int32)


def _both(jfn, pfn, arrays, *args, **kw):
    got = pfn(*(torch.from_numpy(a) for a in arrays), *args, **kw)
    want = jfn(*(jnp.asarray(a) for a in arrays), *args, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert got.shape == want.shape
    return got


@pytest.mark.parametrize("use_cvm", [True, False])
@pytest.mark.parametrize("show_filter", [False, True])
def test_cvm_conv_transform(use_cvm, show_filter):
    pooled = (np.random.RandomState(1).rand(B, S, 3 + E) * 5).astype(
        np.float32)
    got = psp.cvm_conv_transform(torch.from_numpy(pooled), use_cvm,
                                 show_filter)
    want = jsp.cvm_conv_transform(jnp.asarray(pooled), use_cvm, show_filter)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize("use_cvm", [True, False])
@pytest.mark.parametrize("need_filter", [False, True])
@pytest.mark.parametrize("show_filter", [False, True])
def test_with_conv(use_cvm, need_filter, show_filter):
    emb, seg, valid, _ = _arrays(3 + E, seed=2)
    _both(jsp.fused_seqpool_cvm_with_conv, psp.fused_seqpool_cvm_with_conv,
          (emb, seg, valid), B, S, use_cvm=use_cvm, need_filter=need_filter,
          show_coeff=0.3, clk_coeff=1.1, threshold=1.2,
          show_filter=show_filter)


@pytest.mark.parametrize("use_cvm", [True, False])
@pytest.mark.parametrize("show_filter", [False, True])
def test_with_credit(use_cvm, show_filter):
    emb, seg, valid, _ = _arrays(4 + E, seed=3)
    _both(jsp.fused_seqpool_cvm_with_credit,
          psp.fused_seqpool_cvm_with_credit, (emb, seg, valid), B, S,
          use_cvm=use_cvm, show_filter=show_filter)


@pytest.mark.parametrize("use_cvm", [True, False])
@pytest.mark.parametrize("trade_id", [None, 0, 2])
def test_tradew(use_cvm, trade_id):
    emb, seg, valid, _ = _arrays(2 + 3 + E, seed=4)
    _both(jsp.fused_seqpool_cvm_tradew, psp.fused_seqpool_cvm_tradew,
          (emb, seg, valid), B, S, 3, trade_id=trade_id, use_cvm=use_cvm)


@pytest.mark.parametrize("use_cvm", [True, False])
@pytest.mark.parametrize("per_slot", [True, False])
def test_with_diff_thres(use_cvm, per_slot):
    emb, seg, valid, slots = _arrays(2 + E, seed=5)
    thres = np.array([0.8, 1.5, 2.2], np.float32)
    got = psp.fused_seqpool_cvm_with_diff_thres(
        torch.from_numpy(emb), torch.from_numpy(seg),
        torch.from_numpy(valid), torch.from_numpy(slots), B, S, thres,
        use_cvm=use_cvm, xbox_diff_thres_filter=per_slot, threshold=1.3)
    want = jsp.fused_seqpool_cvm_with_diff_thres(
        jnp.asarray(emb), jnp.asarray(seg), jnp.asarray(valid),
        jnp.asarray(slots), B, S, thres, use_cvm=use_cvm,
        xbox_diff_thres_filter=per_slot, threshold=1.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    # the filter dropped some valid keys and kept others
    score = (emb[:, 0] - emb[:, 1]) * 0.2 + emb[:, 1]
    keep = valid & (score >= (thres[slots] if per_slot else 1.3))
    assert 0 < keep.sum() < valid.sum()


@pytest.mark.parametrize("use_cvm", [True, False])
@pytest.mark.parametrize("pclk_num", [1, 3])
def test_with_pcoc(use_cvm, pclk_num):
    emb, seg, valid, _ = _arrays(4 + pclk_num + E, seed=6)
    _both(jsp.fused_seqpool_cvm_with_pcoc, psp.fused_seqpool_cvm_with_pcoc,
          (emb, seg, valid), B, S, pclk_num, use_cvm=use_cvm)


def test_variants_refuse_unsorted_segments():
    emb, seg, valid, slots = _arrays(4 + 3 + E, seed=7)
    bad = seg.copy()
    bad[[1, -1]] = bad[[-1, 1]]
    args = [torch.from_numpy(a) for a in (emb, bad, valid)]
    calls = [
        lambda: psp.fused_seqpool_cvm_with_conv(*args, B, S),
        lambda: psp.fused_seqpool_cvm_with_credit(*args, B, S),
        lambda: psp.fused_seqpool_cvm_tradew(*args, B, S, 3, trade_id=1),
        lambda: psp.fused_seqpool_cvm_with_diff_thres(
            *args, torch.from_numpy(slots), B, S, np.ones(S, np.float32)),
        lambda: psp.fused_seqpool_cvm_with_pcoc(*args, B, S, 3)]
    for call in calls:
        with pytest.raises(ValueError, match="nondecreasing"):
            call()


def test_exported_under_the_reference_names():
    import paddlebox_tpu.ops as jops
    names = ("fused_seqpool_cvm_tradew", "fused_seqpool_cvm_with_conv",
             "fused_seqpool_cvm_with_credit",
             "fused_seqpool_cvm_with_diff_thres",
             "fused_seqpool_cvm_with_pcoc", "cvm_conv_transform",
             "cvm_transform", "fused_seqpool_cvm")
    for n in names:
        assert hasattr(jops, n)
        assert getattr(pops, n) is getattr(psp, n)

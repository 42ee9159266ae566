"""ops/sparse.py pull_sparse and pull_sparse_differentiable against the
JAX package's (paddlebox_tpu/ops/sparse.py:57-62, 123-149) on the CPU.

pull_sparse is the gather_rows pull (its plain version here) and the pull
view: exact. pull_sparse_differentiable's backward is the reference's
slab-shaped scatter-add of the embed_w and embedx cotangents (show and
click get none); the port sums an id's occurrences in ascending order
from zero, which is the order of XLA's scatter-add on the CPU: exact at
tests/test_ops.py:82-114's cases and at a batch with many duplicates,
and exact against index_add_ (the plain scatter-add) on the same
cotangent; an id past the slab adds nothing, as the reference's scatter
drops it. A negative id follows JAX's indexing in both directions: one
in [-C, 0) reads and adds to row C + id, one below -C reads row 0 (the
gather's clamp) and adds nothing (the scatter's drop). A bf16 layout is
refused, as the reference's :124-130.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddlebox_tpu.embedding import accessor as jacc
from paddlebox_tpu.ops import sparse as jsparse

from paddlebox_tpu_torch.embedding import accessor as acc
from paddlebox_tpu_torch.embedding.accessor import ValueLayout
from paddlebox_tpu_torch.ops import (pull_sparse, pull_sparse_differentiable)
from paddlebox_tpu_torch.ops.sparse import pull_view_grad

D = 4
LAYOUT = ValueLayout(D, "adagrad")
JLAYOUT = jacc.ValueLayout(D, "adagrad")


def _loss_torch(emb):
    return (emb[:, 2] ** 2).sum() + emb[:, 3:].sum()


def _grads(slab_np, ids_np):
    """(the port's slab gradient, the reference's) of test_ops.py's
    loss."""
    slab = torch.from_numpy(slab_np.copy()).requires_grad_(True)
    ids = torch.from_numpy(ids_np)
    _loss_torch(pull_sparse_differentiable(slab, ids, LAYOUT)).backward()

    def jloss(s):
        emb = jsparse.pull_sparse_differentiable(s, jnp.asarray(ids_np),
                                                 JLAYOUT)
        return (emb[:, 2] ** 2).sum() + emb[:, 3:].sum()

    return slab.grad.numpy(), np.asarray(jax.grad(jloss)(jnp.asarray(slab_np)))


def test_scatter_add_cases_of_the_reference():
    """tests/test_ops.py:82-104: a duplicate id accumulates, untouched
    rows and the show/click columns get nothing."""
    slab = np.random.RandomState(0).rand(16, LAYOUT.width).astype(np.float32)
    g, jg = _grads(slab, np.array([3, 3, 7], np.int32))
    np.testing.assert_array_equal(g, jg)
    np.testing.assert_allclose(g[3, acc.EMBED_W], 2 * 2 * slab[3, acc.EMBED_W],
                               rtol=1e-5)
    np.testing.assert_allclose(g[7, acc.EMBED_W], 2 * slab[7, acc.EMBED_W],
                               rtol=1e-5)
    xw0 = LAYOUT.embedx_w
    np.testing.assert_allclose(g[3, xw0:xw0 + D], 2.0)
    np.testing.assert_allclose(g[7, xw0:xw0 + D], 1.0)
    assert g[0].sum() == 0
    assert g[3, acc.SHOW] == 0 and g[3, acc.CLICK] == 0


def test_forward_matches_the_pull_and_the_reference():
    """tests/test_ops.py:107-114, and both against the reference."""
    slab = np.random.RandomState(1).rand(8, LAYOUT.width).astype(np.float32)
    ids = np.array([0, 5], np.int32)
    got = pull_sparse(torch.from_numpy(slab), torch.from_numpy(ids), LAYOUT)
    diff = pull_sparse_differentiable(torch.from_numpy(slab),
                                      torch.from_numpy(ids), LAYOUT)
    want = jsparse.pull_sparse(jnp.asarray(slab), jnp.asarray(ids), JLAYOUT)
    np.testing.assert_array_equal(got.numpy(), diff.numpy())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gradient_at_a_batch_with_duplicates():
    """4,096 ids over 300 rows (most repeat): the reference's gradient and
    index_add_'s, bit for bit, for a random cotangent."""
    rng = np.random.RandomState(2)
    slab = rng.randn(300, LAYOUT.width).astype(np.float32)
    ids = rng.randint(0, 300, 4096).astype(np.int32)
    g, jg = _grads(slab, ids)
    np.testing.assert_array_equal(g, jg)
    d_out = torch.from_numpy(rng.randn(4096, 3 + D).astype(np.float32))
    got = pull_view_grad(torch.from_numpy(ids), d_out, slab.shape, LAYOUT)
    want = torch.zeros(slab.shape)
    idx = torch.from_numpy(ids).long()
    want[:, acc.EMBED_W].index_add_(0, idx, d_out[:, 2])
    xw0 = LAYOUT.embedx_w
    want[:, xw0:xw0 + D].index_add_(0, idx, d_out[:, 3:])
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    # an id past the slab adds nothing: the reference's scatter drops it
    past = ids.copy()
    past[::7] = 300
    g, jg = _grads(slab, past)
    np.testing.assert_array_equal(g, jg)
    empty = pull_view_grad(torch.zeros(0, dtype=torch.int32),
                           torch.zeros(0, 3 + D), slab.shape, LAYOUT)
    assert not empty.any()


NEGATIVE_IDS = {
    # slab [8, 13]: the reference reads row C + id for id in [-C, 0)
    "wrap": np.array([1, -1, 3, 1], np.int32),
    # below -C: JAX's gather clamps to row 0, its scatter drops the id
    "below": np.array([1, -1, 3, 1, -8, -9, -100, 8, 100, -2 ** 31,
                       2 ** 31 - 1], np.int32),
}


@pytest.mark.parametrize("case", sorted(NEGATIVE_IDS))
def test_negative_ids_follow_the_reference(case):
    """pull_sparse and pull_sparse_differentiable at negative ids against
    the reference's pull_sparse and its custom VJP: the forward and the
    slab gradient bit for bit, and pull_view_grad against the reference's
    backward for a random cotangent."""
    rng = np.random.RandomState(5)
    slab = rng.rand(8, LAYOUT.width).astype(np.float32)
    assert slab.shape == (8, 13)
    ids = NEGATIVE_IDS[case]
    want = np.asarray(jsparse.pull_sparse(jnp.asarray(slab),
                                          jnp.asarray(ids), JLAYOUT))
    s, i = torch.from_numpy(slab), torch.from_numpy(ids)
    np.testing.assert_array_equal(pull_sparse(s, i, LAYOUT).numpy(), want)
    np.testing.assert_array_equal(
        pull_sparse_differentiable(s, i, LAYOUT).detach().numpy(), want)
    np.testing.assert_array_equal(want[1], pull_sparse(
        s, torch.tensor([7], dtype=torch.int32), LAYOUT).numpy()[0])
    g, jg = _grads(slab, ids)
    np.testing.assert_array_equal(g, jg)
    assert g[7, acc.EMBED_W] != 0       # id -1 adds to row 7
    d_out = rng.randn(ids.shape[0], 3 + D).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jsparse.pull_sparse_differentiable(
        t, jnp.asarray(ids), JLAYOUT), jnp.asarray(slab))
    (jd,) = vjp(jnp.asarray(d_out))
    got = pull_view_grad(i, torch.from_numpy(d_out), slab.shape, LAYOUT)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jd))


def test_bf16_layout_is_refused():
    layout = ValueLayout(D, embed_dtype="bfloat16")
    slab = torch.zeros(4, layout.device_width, dtype=torch.int16)
    with pytest.raises(ValueError, match="float32 slab layout"):
        pull_sparse_differentiable(slab, torch.zeros(2, dtype=torch.int32),
                                   layout)

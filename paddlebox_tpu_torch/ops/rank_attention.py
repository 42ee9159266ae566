"""Join-phase pv ops: rank_attention and batch_fc.

Counterpart of paddlebox_tpu/ops/rank_attention.py:28-68 (the reference's
rank_attention_op and batch_fc_op). Both are gathers and batched products
in the reference, XLA ops and no Pallas kernel, and stay PyTorch ops here.

rank_offset rows (data/pv.py): col 0 the instance's rank in its pv,
1-based (<= 0 invalid); col 2k+1 the rank of peer k, col 2k+2 its row in
the batch.

The reference forms ``param_help = pview[sel]``, [N, R, F, out] (at the
flagship's N 1024, R 3, F 352, out 64, 277 MB a step and its gradient the
same again). The same sum without it: each instance's projection through
every parameter block, ``Y = x @ P`` viewed [N, R*R, out] (R*R products of
[F, out], one matmul), then out[i] = sum over its valid peers k of
Y[peer_idx_ik, sel_ik]. That gather-sum's backward adds each instance's
output gradient into the rows it read; rows read more than once (a peer
shared by a pv) are summed by a sorted segment reduction, not atomics, so
a step's gradients do not vary from run to run on the card.
"""

from __future__ import annotations

from typing import Tuple

import torch


class _GatherSum(torch.autograd.Function):
    """out[i] = sum_k where(valid[i, k], y[flat[i, k]], 0) for y [M, O],
    flat and valid [N, R]; the backward a sorted segment sum over M."""

    @staticmethod
    def forward(ctx, y, flat, valid):
        ctx.save_for_backward(flat, valid)
        ctx.rows = y.shape[0]
        picked = y.index_select(0, flat.reshape(-1)).view(
            flat.shape + y.shape[1:])
        return torch.where(valid[..., None], picked,
                           torch.zeros_like(picked)).sum(dim=1)

    @staticmethod
    def backward(ctx, grad):
        flat, valid = ctx.saved_tensors
        # summed in f32 whatever the compute dtype
        g = grad.float()[:, None, :]
        contrib = torch.where(valid[..., None], g, torch.zeros_like(g))
        contrib = contrib.reshape(-1, grad.shape[-1])
        keys, order = torch.sort(flat.reshape(-1), stable=True)
        bounds = torch.arange(ctx.rows + 1, dtype=keys.dtype,
                              device=keys.device)
        offsets = torch.searchsorted(keys, bounds)
        dy = torch.segment_reduce(contrib.index_select(0, order), "sum",
                                  offsets=offsets, axis=0, unsafe=True)
        return dy.to(grad.dtype), None, None


def rank_attention(x: torch.Tensor, rank_offset: torch.Tensor,
                   rank_param: torch.Tensor, max_rank: int = 3
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [N, F], rank_offset [N, 1 + 2 * max_rank] (integer), rank_param
    [max_rank * max_rank * F, out] -> (out [N, out], ins_rank [N, 1] in
    x's dtype).

    out[i] = sum over peers k of x[idx_k] @ P[(r - 1) * max_rank + (f_k -
    1)], r = rank_offset[i, 0], f_k and idx_k peer k's rank and row, P
    rank_param viewed [max_rank^2, F, out]; a term with r <= 0 or f_k <= 0
    is zero, so an invalid row's output is exactly 0."""
    N, F = x.shape
    out_dim = rank_param.shape[1]
    rr = max_rank * max_rank
    ro = rank_offset.long()
    ins_rank = ro[:, 0]
    ks = torch.arange(max_rank, device=ro.device)
    peer_rank = ro[:, 2 * ks + 1]
    peer_idx = ro[:, 2 * ks + 2]
    valid = (ins_rank[:, None] > 0) & (peer_rank > 0)
    sel = ((ins_rank[:, None] - 1) * max_rank + (peer_rank - 1)).clamp(
        0, rr - 1)
    flat = peer_idx.clamp(0, N - 1) * rr + sel
    # [F, R*R*out]: column block s is parameter block s
    w = rank_param.view(rr, F, out_dim).permute(1, 0, 2).reshape(
        F, rr * out_dim)
    y = torch.matmul(x, w).view(N * rr, out_dim)
    out = _GatherSum.apply(y, flat, valid)
    return out, ins_rank[:, None].to(x.dtype)


def batch_fc(x: torch.Tensor, w: torch.Tensor,
             bias: torch.Tensor) -> torch.Tensor:
    """Per-slot batched FC: x [S, N, in], w [S, in, out], bias [S, out] ->
    [S, N, out], one batched product plus the broadcast bias."""
    return torch.bmm(x, w) + bias[:, None, :]

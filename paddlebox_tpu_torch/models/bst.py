"""BST-style behavior-sequence CTR model on one GPU.

Counterpart of paddlebox_tpu/models/bst.py:45-139. One history slot's keys
keep their order, embed through the pass slab like every pooled slot, get
a learned position embedding and self-attend (the Behavior Sequence
Transformer's shape); the masked mean of the attended sequence joins the
pooled slots in the MLP head. Parameters by the JAX package's names:
``pos_emb`` [seq_len, Din], ``wq``, ``wk``, ``wv`` [Din, heads * d_head],
``wo`` [heads * d_head, d_seq], ``bo`` [d_seq] and the ``dnn`` MLP
(dnn_w{i}, dnn_b{i}) over [total_in + d_seq, *hidden, 1]; Din is the pull
row's width (spec.slot_dim).

Masking, as the reference's: an invalid position becomes a ZERO token
(``where(valid, emb + pos, 0)``), which still takes part in every softmax
with the score q . 0 = 0 (it is not a key mask), and the mean over
positions counts the valid ones, divided by max(count, 1).

``seq_feature_local`` is the reference's (:87-116): one rank's chunk of
T / n_shards positions of the sequence, split over an ``sp`` process group
of n_shards ranks, takes its slice of ``pos_emb``, attends through
``parallel/ring_attention.py`` (ring or Ulysses by ``attn``, across the
group), and the masked mean's numerator and denominator are summed over
the group with autograd (the reference's psums); ``forward`` runs it at
one shard with no collective. The model trains on
``parallel/seq_trainer.py`` SeqCtrTrainer, which pulls the history beside
the pooled slots; BoxTrainer refuses it (``use_sequence``).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from paddlebox_tpu_torch.models.base import ModelSpec
from paddlebox_tpu_torch.models.layers import mlp_apply, mlp_init
from paddlebox_tpu_torch.parallel.ring_attention import (ring_attention,
                                                         ulysses_attention)
from paddlebox_tpu_torch.parallel.tensor_parallel import (LOCAL, group_rank,
                                                          group_size, psum)


class BstSeqCtr(nn.Module):
    """Pooled slots (seqpool + CVM) and an attended behavior sequence into
    an MLP head. seq_len: the padded history length T (divisible by
    n_shards, the ``sp`` group's ranks); attn: "ring" or "ulysses"
    (Ulysses needs heads divisible by n_shards)."""

    name = "bst_seq_ctr"
    task_names = ("ctr",)
    use_sequence = True

    def __init__(self, spec: ModelSpec, seq_len: int, n_shards: int = 1,
                 heads: int = 4, d_head: int = 8, d_seq: int = 16,
                 hidden: Sequence[int] = (64, 32), attn: str = "ring",
                 generator: Optional[torch.Generator] = None) -> None:
        """Parameters are drawn on the CPU from ``generator``; move the
        module afterwards."""
        super().__init__()
        if seq_len % n_shards:
            raise ValueError("seq_len %d must divide by the mesh size %d"
                             % (seq_len, n_shards))
        if attn not in ("ring", "ulysses"):
            raise ValueError("attn must be ring|ulysses, got %r" % (attn,))
        if attn == "ulysses" and heads % n_shards:
            raise ValueError("ulysses needs heads %d divisible by %d"
                             % (heads, n_shards))
        self.spec = spec
        self.seq_len = seq_len
        self.n_shards = n_shards
        self.heads = heads
        self.d_head = d_head
        self.d_seq = d_seq
        self.hidden = tuple(hidden)
        self.attn = attn
        din, hd = spec.slot_dim, heads * d_head

        def mat(*shape):
            return nn.Parameter(0.1 * torch.randn(*shape,
                                                  generator=generator))

        self.pos_emb = mat(seq_len, din)
        self.wq = mat(din, hd)
        self.wk = mat(din, hd)
        self.wv = mat(din, hd)
        self.wo = mat(hd, d_seq)
        self.bo = nn.Parameter(torch.zeros(d_seq))
        mlp_init(self, [spec.total_in + d_seq, *self.hidden, 1], "dnn",
                 generator)

    def _qkv(self, emb_seq: torch.Tensor, seq_valid: torch.Tensor,
             pos_emb: torch.Tensor):
        B, T, _ = emb_seq.shape
        H, Dh = self.heads, self.d_head
        tok = torch.where(seq_valid[..., None], emb_seq + pos_emb[None],
                          torch.zeros_like(emb_seq))
        return tuple((tok @ w).reshape(B, T, H, Dh)
                     for w in (self.wq, self.wk, self.wv))

    def _masked_mean(self, o: torch.Tensor, seq_valid: torch.Tensor,
                     group=LOCAL) -> torch.Tensor:
        B, T = seq_valid.shape
        o = o.reshape(B, T, self.heads * self.d_head) @ self.wo + self.bo
        w = seq_valid.to(torch.float32)[..., None]
        # the mean over the full sequence: the chunks' sums over the group
        num = psum((o * w).sum(dim=1), group)
        den = psum(w.sum(dim=1), group)
        return num / torch.clamp(den, min=1.0)

    def seq_feature_local(self, emb_chunk: torch.Tensor,
                          valid_chunk: torch.Tensor,
                          group=None) -> torch.Tensor:
        """This rank's chunk -> the [B, d_seq] feature of the whole
        sequence, the same on every rank of ``group`` (the sp group of
        n_shards ranks; None: the world, or one shard without a process
        group). emb_chunk: [B, T/P, Din] pulled history embeddings of the
        rank's positions; valid_chunk: [B, T/P] bool. Masked positions
        attend as zero tokens and are left out of the mean."""
        P = group_size(group)
        if P != self.n_shards:
            raise ValueError("the sp group has %d ranks, the model n_shards "
                             "%d" % (P, self.n_shards))
        tl = emb_chunk.shape[1]
        idx = group_rank(group)
        pos = self.pos_emb[idx * tl:(idx + 1) * tl]
        q, k, v = self._qkv(emb_chunk, valid_chunk, pos)
        attend = ring_attention if self.attn == "ring" else ulysses_attention
        return self._masked_mean(attend(q, k, v, group, causal=False),
                                 valid_chunk, group)

    def head_apply(self, pooled: torch.Tensor,
                   seq_feat: torch.Tensor) -> torch.Tensor:
        """[B, num_slots, slot_dim] pooled slots and the sequence feature
        -> logits [B]."""
        x = torch.cat([pooled.reshape(pooled.shape[0], -1), seq_feat],
                      dim=-1)
        return mlp_apply(self, x, "dnn")[:, 0]

    def forward(self, pooled: torch.Tensor, emb_seq: torch.Tensor,
                seq_valid: torch.Tensor) -> torch.Tensor:
        """The one-shard model's logits (seq_feature_local with no
        collective)."""
        return self.head_apply(pooled,
                               self.seq_feature_local(emb_seq, seq_valid,
                                                      LOCAL))

    def oracle_logits(self, pooled: torch.Tensor, emb_seq: torch.Tensor,
                      seq_valid: torch.Tensor) -> torch.Tensor:
        """The same math with the plain softmax attention (the reference's
        single-device oracle, for tests)."""
        q, k, v = self._qkv(emb_seq, seq_valid, self.pos_emb)
        s = torch.einsum("bqhd,bkhd->bhqk", q, k) / (self.d_head ** 0.5)
        o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
        return self.head_apply(pooled, self._masked_mean(o, seq_valid))

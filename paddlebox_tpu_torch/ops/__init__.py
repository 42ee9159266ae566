"""The port's ops under the reference's names
(paddlebox_tpu/ops/__init__.py): the sparse pull and push rows, the
seqpool family, data_norm's updates and batch_fc. ``ops.data_norm`` and
``ops.rank_attention`` stay the submodules (each one's function of that
name is the op); the reference's package shadows both submodules with
the functions."""

from paddlebox_tpu_torch.ops.data_norm import (data_norm_summary_update,
                                               masked_data_norm,
                                               masked_data_norm_stat_update)
from paddlebox_tpu_torch.ops.rank_attention import batch_fc
from paddlebox_tpu_torch.ops.seqpool import (
    cvm_conv_transform, cvm_transform, fused_seqpool_cvm,
    fused_seqpool_cvm_tradew, fused_seqpool_cvm_with_conv,
    fused_seqpool_cvm_with_credit, fused_seqpool_cvm_with_diff_thres,
    fused_seqpool_cvm_with_pcoc, seqpool_sum)
from paddlebox_tpu_torch.ops.sparse import (build_push_grads,
                                            build_push_grads_extended,
                                            pull_sparse,
                                            pull_sparse_differentiable,
                                            pull_sparse_extended)

__all__ = ["pull_sparse", "build_push_grads", "pull_sparse_differentiable",
           "pull_sparse_extended", "build_push_grads_extended",
           "fused_seqpool_cvm", "fused_seqpool_cvm_tradew",
           "fused_seqpool_cvm_with_conv", "fused_seqpool_cvm_with_credit",
           "fused_seqpool_cvm_with_diff_thres",
           "fused_seqpool_cvm_with_pcoc", "cvm_transform",
           "cvm_conv_transform", "seqpool_sum", "data_norm_summary_update", "masked_data_norm",
           "masked_data_norm_stat_update", "batch_fc"]

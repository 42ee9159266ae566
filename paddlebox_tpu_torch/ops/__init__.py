"""The port's ops; the seqpool family under the reference's names
(paddlebox_tpu/ops/__init__.py)."""

from paddlebox_tpu_torch.ops.seqpool import (
    cvm_conv_transform, cvm_transform, fused_seqpool_cvm,
    fused_seqpool_cvm_tradew, fused_seqpool_cvm_with_conv,
    fused_seqpool_cvm_with_credit, fused_seqpool_cvm_with_diff_thres,
    fused_seqpool_cvm_with_pcoc, seqpool_sum)

__all__ = ["cvm_conv_transform", "cvm_transform", "fused_seqpool_cvm",
           "fused_seqpool_cvm_tradew", "fused_seqpool_cvm_with_conv",
           "fused_seqpool_cvm_with_credit",
           "fused_seqpool_cvm_with_diff_thres",
           "fused_seqpool_cvm_with_pcoc", "seqpool_sum"]

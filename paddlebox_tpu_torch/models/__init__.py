from paddlebox_tpu_torch.models.aux_input import CtrDnnAux
from paddlebox_tpu_torch.models.bst import BstSeqCtr
from paddlebox_tpu_torch.models.ctr_dnn import CtrDnn
from paddlebox_tpu_torch.models.deepfm import DeepFM
from paddlebox_tpu_torch.models.dlrm import DLRM
from paddlebox_tpu_torch.models.esmm import ESMM
from paddlebox_tpu_torch.models.join_pv import JoinPvDnn
from paddlebox_tpu_torch.models.layers import mlp_apply, mlp_init
from paddlebox_tpu_torch.models.mmoe import MMoE
from paddlebox_tpu_torch.models.nn_cross import CtrDnnExpand
from paddlebox_tpu_torch.models.wide_deep import WideDeep
from paddlebox_tpu_torch.models.wide_tower import EpMMoE, TpDeepFM

# the port's models by the JAX package's MODEL_ZOO names
MODEL_ZOO = {
    "ctr_dnn": CtrDnn,
    "deepfm": DeepFM,
    "wide_deep": WideDeep,
    "dlrm": DLRM,
    "mmoe": MMoE,
    "esmm": ESMM,
    "ctr_dnn_expand": CtrDnnExpand,
    "join_pv_dnn": JoinPvDnn,
    "ctr_dnn_aux": CtrDnnAux,
    "bst_seq_ctr": BstSeqCtr,
    "tp_deepfm": TpDeepFM,
    "ep_mmoe": EpMMoE,
}

__all__ = ["mlp_init", "mlp_apply", "CtrDnn", "DeepFM", "WideDeep", "DLRM", "MMoE", "ESMM",
           "CtrDnnExpand", "JoinPvDnn", "CtrDnnAux", "BstSeqCtr",
           "TpDeepFM", "EpMMoE", "MODEL_ZOO"]

"""The configuration dataclasses and the flag dataclasses (``flags``),
under the reference's package-level names (paddlebox_tpu/config/
__init__.py)."""

from paddlebox_tpu_torch.config import flags
from paddlebox_tpu_torch.config.configs import (CheckpointConfig,
                                                DataFeedConfig, MeshConfig,
                                                SparseOptimizerConfig,
                                                TableConfig, TrainerConfig)

__all__ = ["flags", "TableConfig", "SparseOptimizerConfig", "DataFeedConfig",
           "TrainerConfig", "CheckpointConfig", "MeshConfig"]

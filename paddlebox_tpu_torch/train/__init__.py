"""The trainer, its pass loops and the checkpoint plane.

``BoxTrainer``, ``CheckpointManager`` and ``StreamingRunner``
(train/streaming_runner.py, the continuous-training entry point) are
exported here, as in the reference's train package; each loads on first
use, so importing a submodule never pulls in the others.
"""

__all__ = ["BoxTrainer", "CheckpointManager", "StreamingRunner"]

_HOME = {"BoxTrainer": "trainer", "CheckpointManager": "checkpoint",
         "StreamingRunner": "streaming_runner"}


def __getattr__(name):
    if name in _HOME:
        import importlib
        mod = importlib.import_module("paddlebox_tpu_torch.train."
                                      + _HOME[name])
        return getattr(mod, name)
    raise AttributeError(name)

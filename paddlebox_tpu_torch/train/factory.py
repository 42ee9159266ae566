"""The trainer factory and the executor facade.

Counterpart of paddlebox_tpu/train/factory.py (TrainerFactory::
CreateTrainer, trainer_factory.cc:68-89, and Executor::RunFromDataset,
executor.cc:163): ``create_trainer`` resolves a reference trainer class
name, so a TrainerDesc written for the reference names its trainer here;
``Executor`` drives one pass of a trainer over a dataset.

BoxPSTrainer, MultiTrainer and DistMultiTrainer are the port's BoxTrainer.
The multi-device and parameter-server trainers (the sharded, PS, heter,
Downpour, pipeline and mesh-tower ones) belong to ROADMAP.md A10: their
names raise NotImplementedError saying so. An unknown name raises
KeyError. ``register_trainer`` adds or overrides a name.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, Callable] = {}

# the reference's names whose trainers are multi-device or parameter-server
# ones (reference factory.py:54-96)
A10_TRAINERS = ("ShardedBoxTrainer", "HeterXpuTrainer", "PSGPUTrainer",
                "HeterTrainer", "HeterCpuWorker", "DownpourTrainer",
                "PipelineTrainer", "CtrPipelineTrainer",
                "HeterPipelineTrainer", "ShardedCtrPipelineTrainer",
                "SectionPSTrainer", "MeshTowerTrainer")
BOX_TRAINERS = ("BoxPSTrainer", "MultiTrainer", "DistMultiTrainer")


def register_trainer(name: str, ctor: Callable) -> None:
    _REGISTRY[name] = ctor


def _builtin(name: str) -> Optional[Callable]:
    if name in BOX_TRAINERS:
        from paddlebox_tpu_torch.train.trainer import BoxTrainer
        return BoxTrainer
    if name in A10_TRAINERS:
        raise NotImplementedError(
            "trainer %r is multi-device or parameter-server work, not "
            "ported yet (ROADMAP.md A10)" % name)
    return None


def create_trainer(name: str, *args, **kwargs):
    """The trainer ``name`` resolves to, built with ``args`` and
    ``kwargs``."""
    ctor = _REGISTRY.get(name) or _builtin(name)
    if ctor is None:
        raise KeyError("unknown trainer %r (registered: %s)"
                       % (name, sorted(_REGISTRY)))
    return ctor(*args, **kwargs)


class Executor:
    """Runs trainers' passes (train_from_dataset, executor.py:2412)."""

    def __init__(self) -> None:
        self._trainers: Dict[int, Any] = {}

    def init_for_dataset(self, trainer_name: str, *args, **kwargs):
        """Build the trainer ``trainer_name`` and keep it for ``close``."""
        tr = create_trainer(trainer_name, *args, **kwargs)
        self._trainers[id(tr)] = tr
        return tr

    def train_from_dataset(self, trainer, dataset, preloaded: bool = False,
                           debug: bool = False) -> Dict[str, float]:
        """One pass, ``trainer.train_pass``; ``debug`` logs its stage
        timers after it (TrainFilesWithProfiler)."""
        stats = trainer.train_pass(dataset, preloaded=preloaded)
        if debug:
            from paddlebox_tpu_torch.obs import log
            from paddlebox_tpu_torch.utils.profiler import timer_report
            log.info(timer_report(trainer.timers, prefix="trainer."))
        return stats

    def infer_from_dataset(self, trainer, dataset):
        """A test pass (SetTestMode pulls): (preds, labels)."""
        return trainer.predict_batches(dataset)

    def close(self) -> None:
        for tr in self._trainers.values():
            if hasattr(tr, "close"):
                tr.close()
        self._trainers.clear()

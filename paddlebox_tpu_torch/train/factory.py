"""The trainer factory and the executor facade.

Counterpart of paddlebox_tpu/train/factory.py (TrainerFactory::
CreateTrainer, trainer_factory.cc:68-89, and Executor::RunFromDataset,
executor.cc:163): ``create_trainer`` resolves a reference trainer class
name, so a TrainerDesc written for the reference names its trainer here;
``Executor`` drives one pass of a trainer over a dataset.

BoxPSTrainer, MultiTrainer and DistMultiTrainer are the port's BoxTrainer;
ShardedBoxTrainer and HeterXpuTrainer (the reference's accelerator-side
trainer) are parallel/sharded_trainer.py's (one process a GPU).
MeshTowerTrainer is parallel/mesh_tower.py's (the model-parallel towers
over an ``mp`` process group). The parameter-server trainers:
PSGPUTrainer is the sharded trainer with its owned shard's store on the
CPU PS (``ps_client=``, ``ps_table_id=``; embedding/ps_store.py),
DownpourTrainer is ps/worker.py's, and HeterTrainer and HeterCpuWorker
are fleet/heter.py's CPU worker, whose dense step runs on a
HeterDenseService. PipelineTrainer is parallel/pipeline.py's GPipeRunner,
CtrPipelineTrainer and HeterPipelineTrainer its CtrPipelineRunner (the
CTR program split over a stage process group). ShardedCtrPipelineTrainer
is its ShardedCtrPipelineRunner (the program split over the sharded pass
table, rank = shard on the (dp, stage) mesh), and SectionPSTrainer the
same runner with its owned shard's store on the CPU PS (``ps_client=``,
``ps_table_id=``), as PSGPUTrainer is to the sharded trainer. An unknown
name raises KeyError. ``register_trainer`` adds or overrides a name.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

_REGISTRY: Dict[str, Callable] = {}

# the pipeline runners over a stage process group (reference
# factory.py:73-82): the GPipe runner and the CTR program split, which
# the reference's HeterPipelineTrainer (trainer.h:341) names too
PIPELINE_TRAINERS = ("PipelineTrainer", "CtrPipelineTrainer",
                     "HeterPipelineTrainer")
# the CTR pipeline over the sharded pass table, and over the CPU PS
# (reference factory.py:39-51, 83-90)
SHARDED_PIPELINE_TRAINERS = ("ShardedCtrPipelineTrainer", "SectionPSTrainer")
BOX_TRAINERS = ("BoxPSTrainer", "MultiTrainer", "DistMultiTrainer")
# HeterXpuTrainer is the reference's accelerator-side trainer, which the
# sharded trainer plays (reference factory.py:59-63)
SHARDED_TRAINERS = ("ShardedBoxTrainer", "HeterXpuTrainer")
PS_TRAINERS = ("PSGPUTrainer", "DownpourTrainer")
HETER_TRAINERS = ("HeterTrainer", "HeterCpuWorker")
MESH_TOWER_TRAINERS = ("MeshTowerTrainer",)


def register_trainer(name: str, ctor: Callable) -> None:
    _REGISTRY[name] = ctor


def _psgpu_trainer(*args, ps_client=None, ps_table_id=0, **kwargs):
    """PSGPUTrainer (reference factory.py:26-38): the sharded trainer with
    its owned shard's store on the CPU PS's sparse table ``ps_table_id``
    (the BuildPull / EndPass composition, ps_gpu_wrapper.cc:337-760).
    Every rank makes one store, and the store of rank 0 alone is the
    primary (process_primary=(rank == 0)), so that a table-wide operation
    reaches the server once a job."""
    from paddlebox_tpu_torch.embedding.ps_store import ps_store_factory
    from paddlebox_tpu_torch.parallel.sharded_trainer import \
        ShardedBoxTrainer
    if ps_client is None:
        raise ValueError("PSGPUTrainer needs ps_client= (a PS client whose "
                         "sparse table backs the pass slabs)")
    # process_primary=(rank == 0), decided here: the rank is the trainer's
    # mesh position, known once it joined the mesh, so the factory makes
    # the store secondary and rank 0's is promoted
    trainer = ShardedBoxTrainer(*args, store_factory=ps_store_factory(
        ps_client, ps_table_id, process_primary=False), **kwargs)
    trainer.table.shard.store.primary = trainer.rank == 0
    return trainer


def _section_ps_trainer(*args, ps_client=None, ps_table_id=0, **kwargs):
    """SectionPSTrainer (reference factory.py:39-51): the sharded pipeline
    with its owned shard's store on the CPU PS's sparse table
    ``ps_table_id`` (section programs over the full PS), the store of rank
    0 alone the primary, as _psgpu_trainer makes it."""
    from paddlebox_tpu_torch.embedding.ps_store import ps_store_factory
    from paddlebox_tpu_torch.parallel.pipeline import \
        ShardedCtrPipelineRunner
    if ps_client is None:
        raise ValueError("SectionPSTrainer needs ps_client= (a PS client "
                         "whose sparse table backs the pass slabs)")
    runner = ShardedCtrPipelineRunner(*args, store_factory=ps_store_factory(
        ps_client, ps_table_id, process_primary=False), **kwargs)
    runner.table.shard.store.primary = runner.rank == 0
    return runner


def _builtin(name: str) -> Optional[Callable]:
    if name in BOX_TRAINERS:
        from paddlebox_tpu_torch.train.trainer import BoxTrainer
        return BoxTrainer
    if name in SHARDED_TRAINERS:
        from paddlebox_tpu_torch.parallel.sharded_trainer import \
            ShardedBoxTrainer
        return ShardedBoxTrainer
    if name == "PSGPUTrainer":
        return _psgpu_trainer
    if name == "DownpourTrainer":
        from paddlebox_tpu_torch.ps.worker import DownpourTrainer
        return DownpourTrainer
    if name in HETER_TRAINERS:
        from paddlebox_tpu_torch.fleet.heter import HeterTrainer
        return HeterTrainer
    if name in MESH_TOWER_TRAINERS:
        from paddlebox_tpu_torch.parallel.mesh_tower import MeshTowerTrainer
        return MeshTowerTrainer
    if name == "PipelineTrainer":
        from paddlebox_tpu_torch.parallel.pipeline import GPipeRunner
        return GPipeRunner
    if name in PIPELINE_TRAINERS:
        from paddlebox_tpu_torch.parallel.pipeline import CtrPipelineRunner
        return CtrPipelineRunner
    if name == "ShardedCtrPipelineTrainer":
        from paddlebox_tpu_torch.parallel.pipeline import \
            ShardedCtrPipelineRunner
        return ShardedCtrPipelineRunner
    if name == "SectionPSTrainer":
        return _section_ps_trainer
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

"""The multi-GPU path (one process a GPU), sequence parallelism and the
model-parallel towers.

parallel/mesh.py (the rank's ShardMesh and the torch.distributed
bring-up), parallel/sharding.py (the key-mod, table-wise and 2-D grid
policies and the grid's replicated hot tier),
parallel/sharded_table.py and parallel/sharded_trainer.py (the sharded
trainer over a ShardedPassTable, its owned shard's SSD tier or CPU PS
store): counterparts of the JAX package's parallel/ modules of those
names for one process a GPU. parallel/tensor_parallel.py (the TP and EP
functions over a process group), ring_attention.py and seq_trainer.py
split a behavior sequence over an ``sp`` process group: the ring's K/V
hops and Ulysses' all-to-all across ranks. mesh_tower.py trains the
models/wide_tower.py towers over an ``mp`` process group. pipeline.py
runs micro-batch pipeline parallelism over a stage process group (the
GPipe runner and the CTR program split, on a (stage,) or (dp, stage)
mesh of mesh.py's make_mesh or device_mesh_1d), and the CTR program
split over the sharded pass table (ShardedCtrPipelineRunner: rank =
shard over the whole mesh).

The reference's names the port has resolve lazily (PEP 562), as the
reference's package does: the zoo's leaf modules import
parallel/tensor_parallel.py and ring_attention.py, and an eager package
would import the trainers, and the zoo again, through them.
"""

_EXPORTS = {
    "device_mesh_1d": ("paddlebox_tpu_torch.parallel.mesh",
                       "device_mesh_1d"),
    "device_mesh_2d": ("paddlebox_tpu_torch.parallel.mesh",
                       "device_mesh_2d"),
    "make_mesh": ("paddlebox_tpu_torch.parallel.mesh", "make_mesh"),
    "PipelineConfig": ("paddlebox_tpu_torch.parallel.pipeline",
                       "PipelineConfig"),
    "GPipeRunner": ("paddlebox_tpu_torch.parallel.pipeline", "GPipeRunner"),
    "CtrPipelineRunner": ("paddlebox_tpu_torch.parallel.pipeline",
                          "CtrPipelineRunner"),
    "ShardedCtrPipelineRunner": ("paddlebox_tpu_torch.parallel.pipeline",
                                 "ShardedCtrPipelineRunner"),
    "mlp_stage_apply": ("paddlebox_tpu_torch.parallel.pipeline",
                        "mlp_stage_apply"),
    "ShardedPassTable": ("paddlebox_tpu_torch.parallel.sharded_table",
                         "ShardedPassTable"),
    "ShardedBatchIndex": ("paddlebox_tpu_torch.parallel.sharded_table",
                          "ShardedBatchIndex"),
    "ShardedBoxTrainer": ("paddlebox_tpu_torch.parallel.sharded_trainer",
                          "ShardedBoxTrainer"),
    "MeshTowerTrainer": ("paddlebox_tpu_torch.parallel.mesh_tower",
                         "MeshTowerTrainer"),
    "SeqCtrTrainer": ("paddlebox_tpu_torch.parallel.seq_trainer",
                      "SeqCtrTrainer"),
    "ring_attention": ("paddlebox_tpu_torch.parallel.ring_attention",
                       "ring_attention"),
    "ulysses_attention": ("paddlebox_tpu_torch.parallel.ring_attention",
                          "ulysses_attention"),
    "tp_mlp_apply": ("paddlebox_tpu_torch.parallel.tensor_parallel",
                     "tp_mlp_apply"),
    "tp_loss_scale": ("paddlebox_tpu_torch.parallel.tensor_parallel",
                      "tp_loss_scale"),
    "tp_fix_grads": ("paddlebox_tpu_torch.parallel.tensor_parallel",
                     "tp_fix_grads"),
    "ep_experts_apply": ("paddlebox_tpu_torch.parallel.tensor_parallel",
                         "ep_experts_apply"),
    "ep_gate_psum": ("paddlebox_tpu_torch.parallel.tensor_parallel",
                     "ep_gate_psum"),
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    try:
        mod_name, attr = _EXPORTS[name]
    except KeyError:
        raise AttributeError("module %r has no attribute %r"
                             % (__name__, name)) from None
    import importlib
    return getattr(importlib.import_module(mod_name), attr)


def __dir__():
    return __all__

"""The multi-GPU path (one process a GPU) and sequence parallelism.

parallel/mesh.py (the rank's ShardMesh and the torch.distributed
bring-up), parallel/sharding.py (the key-mod, table-wise and 2-D grid
policies and the grid's replicated hot tier),
parallel/sharded_table.py and parallel/sharded_trainer.py (the sharded
trainer over a ShardedPassTable): counterparts of the JAX
package's parallel/ modules of those names for one process a GPU. The
sequence-parallel primitives and trainer (ring_attention.py,
seq_trainer.py) run at one shard: the ring's ppermute and Ulysses'
all_to_all across cards, and every n_shards other than 1, wait for their
slice (ROADMAP A10).
"""

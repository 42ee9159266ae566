"""The multi-GPU path (one process a GPU) and sequence parallelism.

parallel/mesh.py (the rank's ShardMesh and the torch.distributed
bring-up), parallel/sharding.py (the key-mod, table-wise and 2-D grid
policies and the grid's replicated hot tier),
parallel/sharded_table.py and parallel/sharded_trainer.py (the sharded
trainer over a ShardedPassTable, its owned shard's SSD tier or CPU PS
store): counterparts of the JAX package's parallel/ modules of those
names for one process a GPU. parallel/tensor_parallel.py (the TP and EP
functions over a process group), ring_attention.py and seq_trainer.py
split a behavior sequence over an ``sp`` process group: the ring's K/V
hops and Ulysses' all-to-all across ranks.
"""

"""Sequence parallelism's primitives and trainer, on one GPU.

Counterparts of paddlebox_tpu/parallel/ring_attention.py and
parallel/seq_trainer.py at one shard: the ring's ppermute and Ulysses'
all_to_all across cards, and every n_shards other than 1, wait for the
port's multi-GPU slice (ROADMAP A10).
"""

"""The runnable demos of the port: the JAX package's examples/ under the
same names, flags and printed lines, on the card (``--device cuda``, the
default; ``--device cpu`` runs each kernel's plain version).

    python -m paddlebox_tpu_torch.examples.train_ctr --passes 2
    python paddlebox_tpu_torch/examples/train_ctr.py --device cpu

Each module's ``main(argv=None)`` runs it in process and returns what it
printed as values. The multi-rank demos (train_sharded, train_pipeline,
train_mesh_tower) are rank programs: fleet/launch.py starts one process a
GPU, and run alone a demo is a world of one.
"""

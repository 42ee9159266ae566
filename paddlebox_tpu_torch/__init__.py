"""PyTorch/CUDA port of paddlebox_tpu.

The JAX package (`paddlebox_tpu`) is the reference; this package keeps its
module names so each counterpart is easy to find, and imports nothing of it
(nor JAX). Entry points take an explicit ``device`` argument that defaults
to ``"cuda"`` and raises when no GPU is present; the tests pass
``device="cpu"``, where every kernel wrapper runs its plain PyTorch version.

Importing the package starts nothing, builds nothing and loads no torch
(it exports ``flags``, the flag dataclasses, where the reference exports
its flag registry): the CUDA kernels (``csrc/*.cu``) are compiled by
``native/build.py`` at their first launch. The runnable demos are
``paddlebox_tpu_torch/examples/``.
"""

__version__ = "0.1.0"

from paddlebox_tpu_torch.config import flags  # noqa: E402,F401

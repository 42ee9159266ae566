"""Device selection shared by every entry point of the port, and the card's
published rates that its bounds divide by."""

from __future__ import annotations

import subprocess
from typing import Union

import torch

DeviceLike = Union[str, torch.device, None]

# NVIDIA H100 SXM data sheet, at its 700 W power limit
HBM_BYTES_PER_S = 3.35e12     # HBM3
F32_FLOPS = 67e12             # f32 outside the tensor cores


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a torch.device; None means ``"cuda"``.

    Never falls back to the CPU on its own: asking for CUDA on a machine
    without a GPU raises, so a run that meant to use the card cannot
    silently measure the CPU. Callers that want the CPU say so."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "paddlebox_tpu_torch: device %r requested but torch finds no "
            "CUDA device; pass device='cpu' to run the plain PyTorch "
            "versions on the CPU" % str(dev))
    if dev.type not in ("cuda", "cpu"):
        raise ValueError("paddlebox_tpu_torch runs on 'cuda' or 'cpu', got "
                         "%r" % str(dev))
    return dev

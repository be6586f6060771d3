"""Device selection for the PyTorch port."""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The device of every entry point that is given ``device=None``: the
    card.  Raises when no CUDA device is visible; the port never falls back
    to the CPU on its own, so a CPU run passes ``device="cpu"``."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "safeincave_torch runs on a CUDA device and none is visible; "
            'pass device="cpu" to run on the CPU')
    return torch.device("cuda")

"""Device selection for the PyTorch port."""
from __future__ import annotations

import torch


def default_device() -> torch.device:
    """``cuda`` when a CUDA device is visible, else ``cpu``."""
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")

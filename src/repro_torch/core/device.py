"""The device an entry point of the port runs on when its caller names
none: CUDA, or an error when there is no card."""
from __future__ import annotations

import torch


def default_device(device) -> torch.device:
    """``device`` as given; None means CUDA (and raises without it)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("repro_torch runs on CUDA; no CUDA device is "
                           "available (pass device='cpu' to run the plain "
                           "versions of the kernels on the CPU)")
    return torch.device("cuda")

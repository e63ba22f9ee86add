"""Where the port runs: ``resolve_device(None)`` is the GPU.

Every constructor and entry point of the port that places tensors takes
``device=None`` and resolves it here, so that nothing runs on the CPU
unless the caller asks for it (the CPU tests pass ``device="cpu"``).
This module imports only ``torch``: ``core/``, ``models/``, ``serve/``,
``convert.py`` and ``api.py`` all import it without a cycle.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the GPU; asking for it without one raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return dev

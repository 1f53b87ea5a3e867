"""PyTorch/CUDA port of the Eudoxus localizer (``repro`` is the JAX original).

The package mirrors ``repro``'s layout and names, so each function has
its counterpart at the same path. It imports ``torch`` and numpy only:
the framework-free modules it needs from ``repro`` are kept here as
copies (``configs/eudoxus.py``, ``data/frames.py``,
``core/environment.py`` and the frontend's pattern tables).

Device policy: entry points run on ``cuda`` unless the caller passes
``device="cpu"``; asking for the default without a GPU raises. Every
fp32 matrix product stays fp32 (TF32 is switched off for cuBLAS and
cuDNN), as in ``repro``.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` by default, raising
    when no GPU is present; ``"cpu"`` (or any explicit device) as
    given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)

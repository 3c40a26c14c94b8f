"""Device selection for the port's entry points."""

from __future__ import annotations

from typing import Optional

import torch


def resolve_device(device: Optional[str] = None) -> torch.device:
    """The device an entry point runs on: CUDA unless ``device`` names another.

    Raises when CUDA is asked for (or nothing is asked for) and no GPU is
    visible: the port never falls back to the CPU on its own. On CUDA it
    turns TF32 off for matmuls and cuDNN convolutions, so f32 runs in true
    f32 as the JAX package does at ``Precision.HIGHEST``.
    """
    dev = torch.device(device or "cuda")
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("CUDA is not available; pass device='cpu' "
                               "(--device cpu) to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    return dev

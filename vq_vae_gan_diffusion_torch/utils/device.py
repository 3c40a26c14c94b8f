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


def compute_autocast(device: torch.device, dtype: torch.dtype = torch.float32):
    """The context a forward runs under at compute type ``dtype``: for
    bfloat16, ``torch.autocast`` to bf16 on ``device``'s type (the
    convolutions and matmuls in bf16 on f32 parameters, as flax's
    ``dtype=bfloat16, param_dtype=float32``); for float32 a context that
    changes nothing. The f32 islands (the codebook's distances, softmaxes,
    normalisation statistics, the losses) cast back to f32 themselves."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"compute dtype {dtype} is neither float32 nor bfloat16")
    return torch.autocast(torch.device(device).type, dtype=torch.bfloat16,
                          enabled=dtype == torch.bfloat16)

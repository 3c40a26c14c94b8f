"""The plain reference of what the benchmark's cells run: plain PyTorch in
float32, written for the benchmark and frozen with it.

Nothing here imports the port (``vq_vae_gan_diffusion_torch``), JAX or the
JAX package. The modules carry the port's ``state_dict`` names, so the
benchmark can draw one set of weights from the seed into both sides
(:mod:`port_bench.weights`); everything the program derives from those
weights (packed or folded weights, tables, schedules) is worked out here
again.

- :mod:`.vqgan`: the stage-1 VQGAN's encoder, quantizer and decoder;
- :mod:`.gpt`: the minGPT prior's full causal forward;
- :mod:`.shuffle_unet`: the gaussian3d prior's ShuffleNet U-Net, eval and
  train mode;
- :mod:`.ddpm`: the cosine-schedule DDPM chain, its noise-MSE loss and the
  sinusoidal lookup table;
- :mod:`.optim`: AdamW, torch's OneCycle lr and beta1, and the EMA.
"""

import contextlib

import torch


@contextlib.contextmanager
def precision(tf32: bool):
    """Matmuls and cuDNN convolutions in true float32 (``tf32`` False, the
    configurations' precision) or in TF32 (True, the control's: the nearest
    precision below it). Restores the previous settings on exit."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

"""Where a reverse step of the discrete VQ-diffusion samplers spends its time
on the card.

    python -m vq_vae_gan_diffusion_torch.profile_discrete [--dtype float32|bfloat16]

Two priors at full width, seeded weights, 16 samples over 256 tokens; for
each, one structured reverse step per call (the noise draw, the denoiser
on the index carry, then the posterior and sample), through
``utils.profiling.report``: host-clock time, the host's time to issue a
step, device time summed over all CUDA kernels, the device's busy share,
and the device time of each kernel by name.

- VQ_Official (configs/inference_config_vqofficial.yml): the carry as a
  [16, 1024, 256, 1] log-onehot image through the BN-folded ShuffleNet
  U-Net (``--dtype`` sets the folded weights' type), then the fused
  posterior-and-sample kernel (B6);
- the transformer prior (codebook 1024, 100 steps, width 512, 4 blocks of
  8 heads, f32): the step with plain ops, with B6, with B6 at trunc_k 881
  (``fast_sample``'s step), and with B7 (``prng``).
"""

from __future__ import annotations

import argparse

import torch

from .config import load_config
from .models.transformer_vq_diffusion import TransformerVQDiffusion
from .models.vq_diffusion_composite import VQDiffusionComposite
from .utils import resolve_device
from .utils.profiling import report

B = 16
CONFIG = "configs/inference_config_vqofficial.yml"


def _step(prior, truncated: bool = False):
    """fn(i): one structured reverse step at t = T-1-i on a fixed random carry."""
    device = torch.device("cuda")
    gen = torch.Generator(device=device).manual_seed(1)
    shape = (B, prior.seq_len, prior.num_classes)
    z = torch.randint(0, prior.num_classes, shape[:2], generator=gen, device=device)
    seeds = prior.posterior_route() == "prng"

    def fn(i: int):
        t = torch.full((B,), prior.num_timesteps - 1 - i, dtype=torch.long, device=device)
        return prior._step_idx(z, t, t, prior._noise(i, shape, None, gen, device, seeds),
                               truncated=truncated)
    return fn


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_discrete needs a CUDA device")
    resolve_device("cuda")

    comp = VQDiffusionComposite(load_config(CONFIG), dtype=getattr(torch, args.dtype))
    comp.unet.init_weights(torch.Generator().manual_seed(0))
    prior = comp.cuda().eval().bind()
    with torch.no_grad():
        report(f"VQ_Official step, U-Net {args.dtype}, B6", _step(prior), 5, 1, "step")
    del comp, prior
    torch.cuda.empty_cache()

    tvq = TransformerVQDiffusion(codebook_size=1024, seq_len=256, diffusion_steps=100,
                                 embedding_dim=512, num_layers=4, num_heads=8)
    tvq.predictor.init_weights(torch.Generator().manual_seed(0))
    tvq = tvq.cuda().eval()
    tvq.diffusion.model_fn = tvq._bind()
    with torch.no_grad():
        for label, mode, truncated in (("plain ops", False, False), ("B6", True, False),
                                       ("B6, trunc_k 881", True, True), ("B7 (prng)", "prng",
                                                                          False)):
            tvq.diffusion.fused_posterior = mode
            report(f"transformer step, {label}", _step(tvq.diffusion, truncated), 20, 5, "step")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

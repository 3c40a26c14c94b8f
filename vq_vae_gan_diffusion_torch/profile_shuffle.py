"""Where a reverse step of the gaussian3d sampler spends its time on the card.

    python -m vq_vae_gan_diffusion_torch.profile_shuffle [--dtype float32|bfloat16]

Builds the prior's U-Net of configs/inference_config_vqdiffusion.yml at
full width (base 64, mults (1, 2, 4, 8), 1000 timesteps, flax-style weights
from seed 0), folds it, and on a state of [16, 256, 96, 1] prints:

- per clipped DDPM reverse step (one U-Net forward through the kernels and
  the update), the report of ``utils.profiling.report``: host-clock time,
  the host's own time to issue one step, the device time summed over all
  CUDA kernels, the device's busy share, and the device time of each kernel
  by name, so the shuffle units can be set against the plain torch ops
  between them (init conv, TimeMLP, resize, concat, final conv, the update);
- the device time of the final cosine argmax, which runs once a chain.
"""

from __future__ import annotations

import argparse

import torch

from .diffusion.gaussian3d import GaussianDiffusion3D, VQGaussianDiffusion3D
from .models.shuffle_infer import apply_folded, fold_unet
from .models.unet_shuffle import ShuffleUNet
from .utils import resolve_device
from .utils.profiling import report

B, N, D, T = 16, 256, 96, 1000
STEPS = 10


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_shuffle needs a CUDA device")
    resolve_device("cuda")
    dtype = getattr(torch, args.dtype)
    unet = ShuffleUNet(T, 256, 1, 1, 64, (1, 2, 4, 8))
    unet.init_weights(torch.Generator().manual_seed(0))
    folded = fold_unet(unet.cuda().eval(), dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B, N, D, 1, generator=gen, device="cuda")
    noise = torch.randn(B, N, D, 1, generator=gen, device="cuda")
    diffusion = GaussianDiffusion3D((N, D), 1, T, T, sample_method="ddpm",
                                    model_fn=lambda x_, sc, tb: apply_folded(folded, x_, tb).float())
    report(args.dtype, lambda i: diffusion._reverse_step(x, T - 1 - i, noise, clipped=True),
           STEPS, 1, "step")

    prior = VQGaussianDiffusion3D(seq_length=N, timesteps=T, sampling_timesteps=T,
                                  vocab_size=1024, gaussian_dim=D).cuda()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    prior.gaussian_to_indices(x)
    start.record()
    prior.gaussian_to_indices(x)
    end.record()
    torch.cuda.synchronize()
    print(f"cosine argmax to [{B}, {N}] indices over 1024 codes: {start.elapsed_time(end):.3f} ms "
          f"once a chain")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

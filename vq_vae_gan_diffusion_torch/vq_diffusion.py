"""The transformer-predictor VQ-Diffusion demo (PyTorch counterpart of the
root ``vq_diffusion.py``): train the prior on ramps of tokens, then sample
it with both samplers.

    python -m vq_vae_gan_diffusion_torch.vq_diffusion [--steps 20] \\
        [--device cuda|cpu] [--fused-posterior on|off|prng]

Adam at ``--lr`` on batches of ``--batch-size`` ramps (token i of a row is
(i + shift) mod codebook, a random shift a row), the loss of
``TransformerVQDiffusion.loss`` with its history threaded through; then
``sample`` of 4 and ``fast_sample`` of 4 (every 4th step). Each structured
reverse step runs through the fused posterior-and-sample kernel that reads
its Gumbel noise (``on``, the default on CUDA), the one that draws it
(``prng``), or plain ops (``off``), as ``generate --fused-posterior`` sets
it. It runs on CUDA unless ``--device cpu``. Text conditioning needs CLIP
weights, which the repository does not hold: under ``--use-text-condition``
``encode_text`` raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

import torch


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Parse ``argv``, train and sample; returns the losses, both samplers'
    indices [4, g, g] and the model."""
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--codebook-size", type=int, default=64)
    parser.add_argument("--seq-len", type=int, default=64)
    parser.add_argument("--diffusion-steps", type=int, default=20)
    parser.add_argument("--steps", type=int, default=20)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--lr", type=float, default=3e-4)
    parser.add_argument("--use-text-condition", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", type=str, default=None, choices=["cuda", "cpu"],
                        help="default cuda; raises when no GPU is visible")
    parser.add_argument("--fused-posterior", type=str, default=None,
                        choices=["on", "off", "prng"],
                        help="the samplers' posterior route (default: on for CUDA)")
    args = parser.parse_args(argv)

    from .config import flag_value
    from .models.transformer_vq_diffusion import TransformerVQDiffusion
    from .utils import resolve_device

    device = resolve_device(args.device)
    mode = args.fused_posterior or ("on" if device.type == "cuda" else "off")
    m = TransformerVQDiffusion(codebook_size=args.codebook_size, seq_len=args.seq_len,
                               diffusion_steps=args.diffusion_steps,
                               use_text_condition=args.use_text_condition,
                               fused_posterior=flag_value(mode))
    m.encode_text(["a ramp of tokens"])                # raises under --use-text-condition
    m.predictor.init_weights(torch.Generator().manual_seed(args.seed))
    m = m.to(device)
    torch.manual_seed(args.seed)                       # the dropout masks
    gen = torch.Generator(device=device).manual_seed(args.seed)
    opt = torch.optim.Adam(m.predictor.parameters(), lr=args.lr)
    lt = m.init_lt_state()
    base = torch.arange(args.seq_len, device=device) % args.codebook_size

    losses = []
    for i in range(args.steps):
        shift = torch.randint(0, args.codebook_size, (args.batch_size, 1), generator=gen,
                              device=device)
        x0 = (base[None, :] + shift) % args.codebook_size
        loss, _, lt = m.loss(x0, lt, gen)
        opt.zero_grad()
        loss.backward()
        opt.step()
        losses.append(float(loss.detach()))
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i}: loss {losses[-1]:.4f}")
    print(f"loss {losses[0]:.4f} -> {losses[-1]:.4f}")

    samples = m.sample(4, generator=gen)
    print("samples:", tuple(samples.shape), "max token", int(samples.max()))
    fast = m.fast_sample(4, skip_step=4, generator=gen)
    print("fast samples:", tuple(fast.shape))
    return {"losses": losses, "samples": samples, "fast": fast, "model": m}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

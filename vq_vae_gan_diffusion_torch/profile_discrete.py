"""Where a reverse step of the discrete VQ-diffusion samplers spends its time
on the card, or what the posterior kernels cost alone.

    python -m vq_vae_gan_diffusion_torch.profile_discrete [--dtype float32|bfloat16]
    python -m vq_vae_gan_diffusion_torch.profile_discrete --posterior

With ``--posterior`` it builds only csrc/discrete_posterior.cu (at the
first call), prints each kernel instance's registers, stack frame and
spills from the build log, and times B6 (``fused_posterior_sample``) and
B7 (``fused_posterior_sample_prng``) at both priors' shapes (logits
[16, 256, 1023] for VQ_Official, [16, 256, 1024] for the transformer),
trunc_k 0 and 881, f32 and bf16 logits: ms a call by CUDA events over
calls issued one by one (as ``chip_smoke.py`` times every kernel), device
ms a call over a CUDA graph of calls, the share of rows equal to the plain
version's, the plain version's ms, and the bound with what sets it. It calls only the public wrappers, so the same file copied
into an older tree (with ``utils/profiling.py``) times that tree's kernels.

Without it:

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
from .utils.profiling import (cuda_graph_ms, cuda_ms, posterior_bound, ptxas_usage, report,
                              smi_line)

B = 16
CONFIG = "configs/inference_config_vqofficial.yml"
N = 256
TRUNC_K = 881                       # fast_sample's top-r at 0.86 of 1025 classes
# K, timesteps and the final mask rate of each prior's schedule
POSTERIOR_PRIORS = {"VQ_Official": (1024, 1000, 0.99999), "transformer": (1025, 100, 0.9)}


def posterior() -> None:
    """The ``--posterior`` probe (module docstring)."""
    from .diffusion.discrete import make_discrete_schedule
    from .ops import _build
    from .ops import discrete_posterior as dp

    card = smi_line()
    _build.library("discrete_posterior")
    log = _build.library_path("discrete_posterior").with_suffix(".log")
    for name, (regs, stack, spill) in sorted(ptxas_usage(log.read_text()).items()):
        print(f"ptxas {name}: {regs} registers, {stack} bytes stack frame, {spill} bytes spill "
              f"stores")
    gen = torch.Generator(device="cuda").manual_seed(5)
    for prior, (k, steps, ctt_T) in POSTERIOR_PRIORS.items():
        km1 = k - 1
        sched = make_discrete_schedule(steps, k, ctt_T).to("cuda")
        coefs = dp.gather_posterior_coefs(sched, torch.full((B,), steps // 2, device="cuda"),
                                          steps)
        x_t = torch.randint(0, k, (B, N), generator=gen, device="cuda")
        x_t[:, ::5] = km1
        gumbel = dp.gumbel_from_uniform(torch.rand(B, N, k, generator=gen, device="cuda"))
        seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), dtype=torch.int32, generator=gen,
                              device="cuda")
        for dtype in (torch.float32, torch.bfloat16):
            logits = (3 * torch.randn(B, N, km1, generator=gen, device="cuda")).to(dtype)
            for label, fn, plain, noise in (
                    ("B6", dp.fused_posterior_sample, dp.reference_posterior_sample, gumbel),
                    ("B7", dp.fused_posterior_sample_prng, dp.reference_posterior_sample_prng,
                     seeds)):
                for trunc_k in (0, TRUNC_K):
                    def call():
                        return fn(logits, x_t, coefs, noise, trunc_k=trunc_k)
                    equal = (call() == plain(logits, x_t, coefs, noise, trunc_k)).float().mean()
                    ms = cuda_ms(call, 50)
                    graph_ms = cuda_graph_ms(call)
                    plain_ms = cuda_ms(lambda: plain(logits, x_t, coefs, noise, trunc_k), 3)
                    by_bytes, by_ops = posterior_bound(B, N, km1, dtype, label == "B7", trunc_k,
                                                       card)
                    print(f"{prior} {label} logits [{B}, {N}, {km1}] {dtype} trunc_k {trunc_k}: "
                          f"kernel {ms:.4f} ms issued one by one, {graph_ms:.4f} ms in a CUDA "
                          f"graph, {100 * equal.item():.3f}% rows equal to plain, plain "
                          f"{plain_ms:.4f} ms, bound {max(by_bytes, by_ops):.4f} ms by "
                          f"{'bytes' if by_bytes >= by_ops else 'operations'}; {card}")
            del logits


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
    parser.add_argument("--posterior", action="store_true",
                        help="time the posterior kernels alone at both priors' shapes")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_discrete needs a CUDA device")
    resolve_device("cuda")
    if args.posterior:
        posterior()
        return 0

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

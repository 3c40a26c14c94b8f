"""Where a reverse step of the gaussian3d sampler spends its time on the card,
or what each ShuffleNet unit shape of one U-Net forward costs.

    python -m vq_vae_gan_diffusion_torch.profile_shuffle [--dtype float32|bfloat16]
    python -m vq_vae_gan_diffusion_torch.profile_shuffle --units gaussian3d|vqofficial [--dtype ...]

With ``--units`` it builds only csrc/shuffle_units.cu (at the first call)
and, at every distinct unit shape of one forward of the U-Net (base 64,
mults (1, 2, 4, 8)) on the path's state ([16, 256, 96, 1] for gaussian3d,
[16, 1024, 256, 1] for VQ_Official), on a seeded random unit, prints the
kernel's ms a call by CUDA events, its max abs error against the plain
version, the bound and what sets it, each kernel's tile plan and the
calls a forward; then each kernel's mean over the forward's calls. It calls only the public
``fused_bottleneck`` / ``fused_downsample``, and prints a plan only where
``ops.shuffle`` has ``bottleneck_plan`` / ``downsample_plan``, so the same
file copied into an older tree times that tree's kernels. The bottleneck is
a control.

Without it, it builds the prior's U-Net of
configs/inference_config_vqdiffusion.yml at full width (base 64, mults
(1, 2, 4, 8), 1000 timesteps, flax-style weights from seed 0), folds it,
and on a state of [16, 256, 96, 1] prints:

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
from .models.shuffle_infer import apply_folded, fold_unet, unet_unit_shapes
from .models.unet_shuffle import ShuffleUNet
from .ops import shuffle
from .utils import resolve_device
from .utils.profiling import cuda_ms, random_unit, report, shuffle_unit_bound, smi_line

B, N, D, T = 16, 256, 96, 1000
STEPS = 10
UNIT_REPS = 10              # timed calls a unit shape in --units
UNIT_GRIDS = {"gaussian3d": (N, D), "vqofficial": (1024, 256)}


def units(grid: str, dtype: torch.dtype) -> None:
    """The ``--units`` probe (module docstring)."""
    card = smi_line()
    h, w = UNIT_GRIDS[grid]
    shapes = unet_unit_shapes(h, w)
    counts: dict = {}
    for u in shapes:
        counts[u] = counts.get(u, 0) + 1
    plan_of = {"K1": getattr(shuffle, "bottleneck_plan", None),
               "K2": getattr(shuffle, "downsample_plan", None)}
    tag = "f32" if dtype == torch.float32 else "bf16"
    gen = torch.Generator(device="cuda").manual_seed(3)
    total = {"K1": [0.0, 0.0, 0], "K2": [0.0, 0.0, 0]}
    for (kind, uh, uw, c_in, c_out), count in counts.items():
        p = random_unit(kind, c_in, c_out, dtype, gen)
        x = torch.randn(B, uh, uw, c_in, generator=gen, device="cuda").to(dtype)
        kernel, plain = ((shuffle.fused_bottleneck, shuffle.reference_bottleneck) if kind == "K1"
                         else (shuffle.fused_downsample, shuffle.reference_downsample))
        got = kernel(x, p)
        err = (got.float() - plain(x, p).float()).abs().max().item()
        ms = cuda_ms(lambda: kernel(x, p), UNIT_REPS)
        by_bytes, by_ops = shuffle_unit_bound(kind, uh, uw, c_in, c_out, B, dtype, card)
        ch = c_in // 2 if kind == "K1" else c_in
        plan = "" if plan_of[kind] is None else f"; {plan_of[kind](B, uh, uw, ch, c_out // 2)}"
        print(f"{grid} {tag} {kind} {uh}x{uw} {c_in}->{c_out} (x{count} a forward): "
              f"kernel {ms:.4f} ms, max abs err {err:.3e}, bound {max(by_bytes, by_ops):.4f} ms "
              f"by {'bytes' if by_bytes >= by_ops else 'operations'}{plan}")
        t = total[kind]
        t[0] += count * ms
        t[1] += count * max(by_bytes, by_ops)
        t[2] += count
        del x, p, got
    for kind, (ms, bound, n) in total.items():
        print(f"{grid} {tag} {kind}: mean over one forward's {n} calls "
              f"{ms / n:.4f} ms (bound {bound / n:.4f}); {ms:.3f} ms a forward; {card}")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--units", choices=sorted(UNIT_GRIDS),
                        help="time each unit shape of one U-Net forward on this path's grid")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_shuffle needs a CUDA device")
    resolve_device("cuda")
    dtype = getattr(torch, args.dtype)
    if args.units:
        units(args.units, dtype)
        return 0
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

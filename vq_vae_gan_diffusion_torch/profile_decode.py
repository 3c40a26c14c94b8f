"""Where the decode stack's time goes on the card.

    python -m vq_vae_gan_diffusion_torch.profile_decode [--dtype float32|bfloat16]

Runs the decode-stack kernel over the positions t = 0..255 of the serving
path (GPT prior of configs/inference_config_small.yml: C=1024, L=12, H=16,
batch 16, seeded N(0, 0.02) weights, a random cache) and prints:

- the host-clock time per call with the device synchronised at the end;
- the host's own time per call: a few calls issued without a synchronise;
- the device time per call summed over all CUDA kernels, and the device's
  busy share of the host-clock window, from ``torch.profiler``;
- the device time of each CUDA kernel by name, per decode call.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .models.mingpt import GPT
from .ops.gpt_decode import fused_decode_stack, pack_decode_params

L, C, H, B, N = 12, 1024, 16, 16, 256
ENQUEUE_CALLS = 4   # about 100 launches a call; the launch queue holds about 1000


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    dtype = getattr(torch, args.dtype)
    gpt = GPT(vocab_size=1024, block_size=512, n_layer=L, n_head=H, n_embd=C)
    gpt.init_weights(torch.Generator().manual_seed(0))
    packed = pack_decode_params(gpt.cuda(), dtype)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B, C, generator=gen, device="cuda")
    kv = torch.randn(L, B, N, 2 * C, generator=gen, device="cuda").to(dtype)

    def sweep():
        for t in range(N):
            fused_decode_stack(x, packed, kv, t, n_head=H)

    sweep()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sweep()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / N

    # the host's own cost: a few calls issued with no synchronise, few enough
    # that their launches fit the launch queue and the host never waits
    t0 = time.perf_counter()
    for t in range(ENQUEUE_CALLS):
        fused_decode_stack(x, packed, kv, t, n_head=H)
    enqueue_ms = 1e3 * (time.perf_counter() - t0) / ENQUEUE_CALLS
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        sweep()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    dev_us = sum(e.self_device_time_total for e in kernels)
    print(f"{args.dtype}: host clock {wall_ms:.4f} ms/call; host enqueue {enqueue_ms:.4f} "
          f"ms/call; device {dev_us / 1e3 / N:.4f} "
          f"ms/call; device busy {100 * dev_us / 1e3 / window_ms:.1f}% of the profiled "
          f"window ({window_ms / N:.4f} ms/call); {torch.cuda.get_device_name(0)}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total):
        print(f"  {e.self_device_time_total / N:9.2f} us/call  {e.count // N:4d} launches/call  "
              f"{e.key[:90]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

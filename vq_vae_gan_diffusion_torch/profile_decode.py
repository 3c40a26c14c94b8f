"""Where the decode stack's time goes on the card.

    python -m vq_vae_gan_diffusion_torch.profile_decode [--dtype float32|bfloat16]
        [--quant none|int8|int8kv|int4|int4kv]

Runs the decode-stack kernel over the positions t = 0..255 of the serving
path (GPT prior of configs/inference_config_small.yml: C=1024, L=12, H=16,
batch 16, seeded N(0, 0.02) weights, a random cache) and prints, per decode
call, the report of ``utils.profiling.report``: host-clock time, the host's
own issue time, device time summed over all CUDA kernels, the device's busy
share, and the device time of each CUDA kernel by name. ``--quant`` takes
the quantized kernels of ``decode_quant`` instead (``--dtype`` is then the
compute type): int8 or int4 weights, and for the *kv modes an int8 cache
of random levels with per-row scales in [0.005, 0.02].
"""

from __future__ import annotations

import argparse

import torch

from .models.mingpt import GPT
from .ops.gpt_decode import (fused_decode_stack, fused_decode_stack_q, fused_decode_stack_qkv,
                             pack_decode_params)
from .utils.profiling import report

L, C, H, B, N = 12, 1024, 16, 16, 256
ENQUEUE_CALLS = 4   # about 100 launches a call; the launch queue holds about 1000


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dtype", default="float32", choices=["float32", "bfloat16"])
    parser.add_argument("--quant", default="none",
                        choices=["none", "int8", "int8kv", "int4", "int4kv"])
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_decode needs a CUDA device")
    dtype = getattr(torch, args.dtype)
    gpt = GPT(vocab_size=1024, block_size=512, n_layer=L, n_head=H, n_embd=C)
    gpt.init_weights(torch.Generator().manual_seed(0))
    quant = None if args.quant == "none" else args.quant
    packed = pack_decode_params(gpt.cuda(), dtype, quant)
    gen = torch.Generator(device="cuda").manual_seed(1)
    x = torch.randn(B, C, generator=gen, device="cuda")
    if quant in ("int8kv", "int4kv"):
        kv = torch.randint(-127, 128, (L, B, N, 2 * C), generator=gen, device="cuda",
                           dtype=torch.int8)
        sc = 0.005 + 0.015 * torch.rand(L, B, N, 2, generator=gen, device="cuda")

        def call(t):
            return fused_decode_stack_qkv(x, packed, kv, sc, t, n_head=H, compute_dtype=dtype)
    else:
        kv = torch.randn(L, B, N, 2 * C, generator=gen, device="cuda").to(dtype)
        fn = fused_decode_stack_q if quant else fused_decode_stack

        def call(t):
            return fn(x, packed, kv, t, n_head=H)
    report(f"{args.dtype}, quant {args.quant}", call, N, ENQUEUE_CALLS, "call")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

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

The kernel is one launch a call, so the profiler sees one kernel. The time
by phase comes from the kernel's own %globaltimer stamps
(``ops.gpt_decode.record_phase_stamps``), taken over the same 256 calls:
for each phase, its work (from the barrier in front of it until the last
block arrives at the next one) and the barrier (from that arrival until
block 0 leaves it), summed by kind (GEMV, attention, LayerNorm, GELU) per
call, and the launch ramp (first to last block's start).
"""

from __future__ import annotations

import argparse

import torch

from .models.mingpt import GPT
from .ops.gpt_decode import (fused_decode_stack, fused_decode_stack_q, fused_decode_stack_qkv,
                             pack_decode_params, record_phase_stamps, stamp_rows)
from .utils.profiling import report

L, C, H, B, N = 12, 1024, 16, 16, 256
ENQUEUE_CALLS = 8
PHASES = ("LN1", "QKV", "attention", "proj", "LN2", "fc1", "GELU", "fc2")   # a layer's
KINDS = {"LN1": "LayerNorm", "LN2": "LayerNorm", "QKV": "GEMV", "proj": "GEMV",
         "fc1": "GEMV", "fc2": "GEMV", "attention": "attention", "GELU": "GELU"}


def phase_report(call, calls: int) -> None:
    """Run ``call(t)`` for t < calls with phase stamps on and print the
    microseconds a call by phase kind (see the module's doc)."""
    rows = stamp_rows(L)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cap = 2 + rows * (8 * sms + 1)   # at most 8 blocks of 256 threads an SM
    buf = torch.zeros(calls, cap, dtype=torch.int64, device="cuda")
    try:
        for t in range(calls):
            record_phase_stamps(buf[t])
            call(t)
    finally:
        record_phase_stamps(None)
    s = buf.cpu()
    g, r = int(s[0, 0]), int(s[0, 1])
    if r != rows or not (s[:, 0] == g).all():
        raise RuntimeError(f"stamps header {g}, {r}: expected {rows} rows")
    st = s[:, 2:2 + r * (g + 1)].reshape(calls, r, g + 1).double() / 1e3   # us
    start, end = st[:, 0, :g].min(1).values, st[:, -1, :g].max(1).values
    exits, arrive = st[:, 1:-1, g], st[:, 1:-1, :g].max(2).values
    prev = torch.cat([start[:, None], exits[:, :-1]], 1)
    work, wait = (arrive - prev).mean(0), (exits - arrive).mean(0)
    by_kind = {}
    for i in range(8 * L):
        kind = KINDS[PHASES[i % 8]]
        w, b = by_kind.get(kind, (0.0, 0.0))
        by_kind[kind] = (w + work[i].item(), b + wait[i].item())
    w, b = by_kind["LayerNorm"]
    by_kind["LayerNorm"] = (w + (end - exits[:, -1]).mean().item(), b)
    ramp = (st[:, 0, :g].max(1).values - start).mean().item()
    total = (end - start).mean().item()
    print(f"  by phase (kernel stamps, grid {g} blocks, {8 * L} barriers a call): "
          f"{total:.2f} us/call from the first block's start to the last block's end; "
          f"launch ramp {ramp:.2f} us")
    for kind, (w, b) in sorted(by_kind.items(), key=lambda kv: -kv[1][0] - kv[1][1]):
        print(f"  {kind:>10}: work {w:9.2f} us/call, barrier {b:8.2f} us/call")
    print(f"  {'all':>10}: work {sum(w for w, _ in by_kind.values()):9.2f} us/call, "
          f"barrier {sum(b for _, b in by_kind.values()):8.2f} us/call")


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
    phase_report(call, N)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

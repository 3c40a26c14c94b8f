#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits non-zero:

  (a) the card (nvidia-smi name and power limit), torch and CUDA versions;
      fails when torch sees no CUDA device;
  (b) build every kernel under vq_vae_gan_diffusion_torch/csrc/ with nvcc,
      all sources at once, and print the ptxas usage lines;
  (c) each kernel against its plain PyTorch version at the main path's
      shapes, in f32 and bf16, with the tolerance stated; times of the
      kernel and the plain version over the main path's 256 positions;
  (d) the main path: ``vq_vae_gan_diffusion_torch.generate`` on
      configs/inference_config_small.yml at full width (16 samples x 256
      tokens -> [16, 256, 256, 3] images, f32, seeded random weights), with
      the kernel's launch count checked; run cold, then warm;
  (e) the kernel route and the ``fused=False`` module route sample identical
      tokens at temperature 1e-4.

Before the last line it prints one JSON line describing every kernel of the
path, and the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import torch

CONFIG = "configs/inference_config_small.yml"
# full width of the GPT prior in CONFIG, at --n-samples 16
L, C, H, B, N = 12, 1024, 16, 16, 256
F32_PEAK_FLOPS = 67e12      # H100 SXM, f32 outside the tensor cores
BF16_PEAK_FLOPS = 989e12    # H100 SXM, dense bf16 tensor cores


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def hbm_bytes_per_s(name: str) -> float:
    """Published device-memory rate of the H100 variant ``name`` names."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


def cuda_ms(fn, reps: int = 1) -> float:
    """Milliseconds per call of ``fn`` by CUDA events, after one warm-up call."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch sees no CUDA device")
    line = smi_line()
    print(f"(a) nvidia-smi: {line}")
    print(f"(a) torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    return line


def phase_build() -> None:
    from vq_vae_gan_diffusion_torch.ops import _build

    t0 = time.perf_counter()
    logs = _build.build_all()
    print(f"(b) built {sorted(logs)} in {time.perf_counter() - t0:.2f} s")
    for name, log in logs.items():
        for line in log.splitlines():
            if "Used" in line or "spill" in line:
                print(f"(b) {name}: {line.strip()}")


def random_packed(dtype: torch.dtype, gen: torch.Generator) -> dict:
    def rnd(*shape, scale=1.0, base=0.0):
        return base + scale * torch.randn(*shape, generator=gen, device="cuda")
    return {
        "ln1_s": rnd(L, C, scale=0.1, base=1.0), "ln1_b": rnd(L, C, scale=0.1),
        "wqkv": rnd(L, 3 * C, C, scale=0.02).to(dtype), "bqkv": rnd(L, 3 * C, scale=0.02),
        "wproj": rnd(L, C, C, scale=0.02).to(dtype), "bproj": rnd(L, C, scale=0.02),
        "ln2_s": rnd(L, C, scale=0.1, base=1.0), "ln2_b": rnd(L, C, scale=0.1),
        "wfc1": rnd(L, 4 * C, C, scale=0.02).to(dtype), "bfc1": rnd(L, 4 * C, scale=0.02),
        "wfc2": rnd(L, C, 4 * C, scale=0.02).to(dtype), "bfc2": rnd(L, C, scale=0.02),
    }


def decode_stack_bound_ms(dtype: torch.dtype, name: str) -> tuple[float, str]:
    """Least time of one call, averaged over the positions t = 0..N-1 of the
    main path: bytes (weights, f32 params, x in and out, cache rows < t read,
    new rows written) over the memory rate, or operations over the peak rate
    for the weights' type, whichever is larger."""
    es = torch.tensor([], dtype=dtype).element_size()
    weights = L * 12 * C * C * es + L * 13 * C * 4
    mean_t = (N - 1) / 2
    bytes_ = weights + 2 * B * C * 4 + L * B * mean_t * 2 * C * es + L * B * 2 * C * es
    ops = 2 * B * L * 12 * C * C + 4 * B * L * mean_t * C
    peak = F32_PEAK_FLOPS if dtype == torch.float32 else BF16_PEAK_FLOPS
    by_bytes, by_ops = bytes_ / hbm_bytes_per_s(name), ops / peak
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def phase_kernel(card: str) -> dict:
    """The decode-stack kernel against reference_decode_stack at full width.

    Tolerance: max |kernel - plain| <= tol * max(1, max |plain|), per output.
    f32, tol 1e-4: both sum the same f32 products in other orders over
    K <= 4096 and 12 layers. bf16, tol 2e-2: both round the same operands to
    bf16, but a different f32 sum order can move a value across a rounding
    boundary -- one bf16 step, 2^-8 of it -- which LayerNorm and the later
    layers carry on; summing the plain version's products in f64 instead of
    f32 alone moves its output by up to 0.35% of max |x_out| at these shapes.
    """
    from vq_vae_gan_diffusion_torch.ops.gpt_decode import (fused_decode_stack,
                                                           reference_decode_stack)
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        packed = random_packed(dtype, gen)
        x = torch.randn(B, C, generator=gen, device="cuda")
        kv = torch.randn(L, B, N, 2 * C, generator=gen, device="cuda").to(dtype)
        worst = 0.0
        for t in (0, 1, 63, 64, 255):
            h_k, kv_k = fused_decode_stack(x, packed, kv, t, n_head=H)
            h_r, kv_r = reference_decode_stack(x, packed, kv, t, n_head=H)
            torch.cuda.synchronize()
            for what, got, want in (("x_out", h_k, h_r), ("kv_new", kv_k, kv_r)):
                got, want = got.float(), want.float()
                if not torch.isfinite(got).all():
                    raise AssertionError(f"{dtype} t={t} {what}: non-finite values")
                err = (got - want).abs().max().item()
                scale = max(1.0, want.abs().max().item())
                print(f"(c) {dtype} t={t:3d} {what}: max abs err {err:.3e}, "
                      f"max |plain| {scale:.3f}, err / scale {err / scale:.3e}")
                if err > tol * scale:
                    raise AssertionError(f"{dtype} t={t} {what}: error above {tol} of scale")
                worst = max(worst, err)

        def sweep(fn):
            return lambda: [fn(x, packed, kv, t, n_head=H) for t in range(N)]
        ms = cuda_ms(sweep(fused_decode_stack)) / N
        plain_ms = cuda_ms(sweep(reference_decode_stack)) / N
        bound, bound_by = decode_stack_bound_ms(dtype, card)
        print(f"(c) {dtype}: kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, "
              f"bound {bound:.4f} ms/call by {bound_by} (mean over t = 0..{N - 1}); "
              f"kernel {ms * N:.2f} ms per {N}-token run; {card}")
        result[dtype] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": bound_by}
        del packed, kv
    return result


def phase_main() -> int:
    """The main path through the user's entry point, cold then warm. Returns
    the kernel launches counted in the cold run."""
    from vq_vae_gan_diffusion_torch import generate
    from vq_vae_gan_diffusion_torch.ops.gpt_decode import fused_decode_stack

    argv = ["--config", CONFIG, "--n-samples", str(B), "--seed", "42", "--device", "cuda"]
    counted = None
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        fused_decode_stack.launches = 0
        t0 = time.perf_counter()
        out = generate.run(argv)
        total = time.perf_counter() - t0
        launches = fused_decode_stack.launches
        counted = launches if counted is None else counted
        tokens, images = out["tokens"], out["images"]
        if tuple(tokens.shape) != (B, 256):
            raise AssertionError(f"tokens shape {tuple(tokens.shape)}")
        if int(tokens.min()) < 0 or int(tokens.max()) >= 1024:
            raise AssertionError("tokens outside [0, 1024)")
        if tuple(images.shape) != (B, 256, 256, 3) or not torch.isfinite(images).all():
            raise AssertionError(f"images {tuple(images.shape)} not finite of [16,256,256,3]")
        if launches != 256:
            raise AssertionError(f"{launches} decode-stack launches, expected 256 "
                                 "(256 positions x 1 call)")
        sec = out["seconds"]
        print(f"(d) {run}: {launches} decode-stack launches; decode loop "
              f"{1e3 * sec['sample'] / 256:.3f} ms/token, "
              f"{B * 256 / sec['sample']:.1f} tokens/s; VQVAE decode {sec['decode']:.3f} s; "
              f"total {total:.2f} s; max memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; grid {out['path']}")
    return counted


def phase_routes() -> None:
    """Kernel route and module route pick identical tokens at temperature 1e-4."""
    from vq_vae_gan_diffusion_torch.models.mingpt import GPT, sample_tokens

    gpt = GPT(vocab_size=1024, block_size=512, n_layer=L, n_head=H, n_embd=C)
    gpt.init_weights(torch.Generator().manual_seed(1))
    gpt = gpt.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(2)
    prefix = torch.cat([torch.zeros(B, 1, dtype=torch.long, device="cuda"),
                        torch.randint(0, 1024, (B, 8), generator=gen, device="cuda")], 1)
    toks = {}
    for fused in (True, False):
        g = torch.Generator(device="cuda").manual_seed(3)
        toks[fused] = sample_tokens(gpt, prefix, 9, 32, temperature=1e-4, top_k=100,
                                    fused=fused, generator=g)
    same = bool((toks[True] == toks[False]).all())
    print(f"(e) kernel route vs fused=False, {B} x 32 tokens at temperature 1e-4: "
          f"{'identical' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("kernel route and module route sampled different tokens")


def main() -> int:
    card = phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timing = phase_kernel(card)
    launches = phase_main()
    phase_routes()
    f32 = timing[torch.float32]
    kernels = [{
        "name": "gpt_decode_stack", "route": "cuda",
        "source": "vq_vae_gan_diffusion_torch/csrc/gpt_decode.cu",
        "replaces": "vq_vae_gan_diffusion_tpu/ops/gpt_decode_pallas.py:181",
        "launches": launches, "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": None,
    }]
    for k in kernels:
        if not all(math.isfinite(k[key]) for key in ("max_abs_err", "ms", "plain_ms", "bound_ms")):
            raise AssertionError(f"non-finite numbers for {k['name']}")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

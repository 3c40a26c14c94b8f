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
      through torch.profiler, exactly one CUDA kernel a decode-stack call
      in each instantiation, with its device time and the host's issue
      time beside the bound;
  (d) the main path: ``vq_vae_gan_diffusion_torch.generate`` on
      configs/inference_config_small.yml at full width (16 samples x 256
      tokens -> [16, 256, 256, 3] images, f32, seeded random weights), with
      the kernel's launch count checked; run cold, then warm;
  (e) the kernel route and the ``fused=False`` module route sample identical
      tokens at temperature 1e-4;
  (f) the ShuffleNet bottleneck and downsample kernels against their plain
      versions at every distinct unit shape of the gaussian3d U-Net forward
      (state [16, 256, 96, 1], base 64, mults (1, 2, 4, 8)), in f32 and
      bf16, the downsample's silu(x + t_vec) prologue included; each shape's
      kernel time, plain time and bound, and each kernel's tile plan
      (``ops.shuffle.bottleneck_plan`` / ``downsample_plan``); then, in f32,
      at shapes off that path (every unit of the U-Net on the mnist config's
      odd grids, the downsample's prologue on odd grids, short last tiles in
      rows and columns, widths that fill no whole tile of the pointwise
      products, branches wider than one 256-column pass); both kernels'
      C entry points refuse shared memory short of the tile's or above a
      block's;
  (g) the second path: ``vq_vae_gan_diffusion_torch.generate`` on
      configs/inference_config_vqdiffusion.yml at full width (16 samples,
      1000 clipped DDPM steps of the U-Net, cosine argmax to [16, 256]
      indices, VQVAE decode to [16, 256, 256, 3] images, f32, seeded random
      weights), with both kernels' launch counts checked; cold, then warm;
  (h) the kernel route against the ``fused_sampler: False`` module route:
      one full-width U-Net forward, and a 20-step chain at full width with
      the same noise (at least 99% of indices equal);
  (i) the fused posterior-and-sample kernels, with Gumbel noise read (B6)
      and drawn by Philox in the kernel (B7), against their plain versions
      at the two discrete priors' shapes (logits [16, 256, 1023] and
      [16, 256, 1024]), f32 and bf16 logits, trunc_k 0 and 881, carries with
      masked positions, t in {0, 1, T/2, T-1}: at least 99.9% of indices
      equal, and at every other row the plain version's two best scores
      within 1e-4; each shape's kernel time (device time from a CUDA
      graph of 20 calls, and issued one call at a time), plain time and
      bound; each kernel instance's registers from ptxas (no stack frame,
      no spill); the same checks off the paths: K in {2, 129, 1025, 2048}
      (rows staged in shared memory) and {2049, 4097, 2^20} (rows read
      from device memory), row counts no multiple of the rows a block,
      trunc_k in {0, 1, K-1, K}, rows of all-equal logits, f32 and bf16;
      both kernels' time at the wide prior's [16, 256, 2048] logits (K =
      2049) beside the plain version's and the bound; then B7's samples at
      fixed logits over 4096 seeds (1,048,576 draws) against softmax(ev),
      total variation below 0.02;
  (j) the third path: ``vq_vae_gan_diffusion_torch.generate`` on
      configs/inference_config_vqofficial.yml at full width (16 samples,
      the ShuffleNet U-Net on the [16, 1024, 256, 1] log-onehot image, K =
      1024 classes over 256 tokens, VQVAE decode to [16, 256, 256, 3]) with
      the chain cut to 20 steps (t = 19..0 of the 1000-step schedule): 19
      B6, 780 K1 and 80 K2 launches; cold, then warm; K1 and K2 against
      their plain versions at every unit shape of this U-Net (1024x256 down
      to 64x16), with each kernel's tile plan; ``fused_posterior`` on
      against off with the same noise over the 20 steps (at least 99% of
      indices equal);
  (k) the transformer prior (codebook 1024, 256 tokens, 100 steps, width
      512, 4 blocks of 8 heads, 16 samples, seeded weights): ``sample``
      with plain ops, with B6 (99 launches) and under ``prng`` with B7 (99
      launches), and ``fast_sample`` (skip 4, top-r 0.86: 24 B6 launches at
      trunc_k 881); indices in [0, 1023];
  (l) the quantized decode-stack kernels, B2b (int8 or int4 weights, float
      cache) and B2c (the same with an int8 KV cache), against their plain
      versions at full width in all four modes (int8, int8kv, int4,
      int4kv), f32 and bf16 compute, t in {0, 1, 63, 64, 255}, on a
      pre-filled cache: x_out within tol x max(1, max |plain|) (1e-4 f32,
      2e-2 bf16), the new int8 rows at most one level apart and at least
      99.9% equal, their scales within 1e-5 relative; each mode's kernel time
      (mean over t = 0..255), plain time and bound; one CUDA kernel a call
      in each of the eight instantiations, as in (c);
  (m) the fourth path: ``vq_vae_gan_diffusion_torch.generate`` on
      configs/inference_config_int8kv.yml (the GPT path of (d) with
      ``decode_quant: int8kv``), cold then warm: 256 B2c launches and no B1;
      then ``sample_tokens`` at full width under int8, int4 and int4kv (256
      launches each of B2b, B2b and B2c);
  (n) the int8kv kernel route against the plain route (the model on the
      CPU), 32 tokens at temperature 1e-4 after the same prefix with the
      same noise, both routes stepping through the plain route's sequence:
      at least 99% of tokens equal;
  (o) stage-1 training on configs/training_config_mnist.yml at full width
      (VQVAE latent 64 at 7x7, channels [64, 128, 128], 1024 codes; PatchGAN
      64-128-256-512; LPIPS VGG16; synthetic data, as the card's machine
      holds no data/): ``python -m vq_vae_gan_diffusion_torch.train
      --debug`` writes metrics.jsonl and a checkpoint, then four epochs at
      batch 200, each split into the host's time in the loader, in the
      artifacts and the steps, give the loop's images/s (the first epoch
      with its setup, the other three warm); ``train_step`` at
      batch 200 @ 28x28x1, f32, warm, before disc_start (disc_factor 0) and
      after it (disc_factor 1, lambda > 0 and finite): ms a step, images/s,
      peak device memory, through torch.profiler the device's busy share
      and the top kernels, the step's operations (torch.utils.flop_counter)
      and its bound at the f32 peak, and the step's layers timed alone (VQVAE, LPIPS,
      one discriminator call, each forward and backward; both Adam steps),
      printed as one JSON line; one step from the same
      weights and batch on the card and on the CPU: at least 99.9% of
      codebook indices equal, every metric within 1e-3 relative, each
      leaf's gradient, where it is above rounding, no further from a
      float64 step's (on the CPU) than the larger of twice the CPU's f32
      gradient's distance and 1e-4 of its largest entry, every parameter within 2 lr of the CPU's
      and in each such leaf 99% within lr / 10, running statistics within
      1e-4; then a
      K = 2049 transformer prior (2048 codes, width 64) over 256 positions
      samples through B6 under fused_posterior on and B7 under prng (rows
      read from device memory, as the JAX sampler takes its kernel at
      this fits_vmem shape), and over 1024 positions, past fits_vmem, with
      no posterior launch; indices in [0, 2047]. Stage 1 runs no
      hand-written kernel: its convolutions are cuDNN's, its products
      cuBLAS's.

Each path, (d), (g), (j), (m) and each run of (k), runs with every kernel's
launch count set to 0 just before it and read just after. Before the last line it prints one JSON line
describing every kernel of the paths, and the card's name and power limit;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import sys
import time

import torch

from vq_vae_gan_diffusion_torch.models.shuffle_infer import unet_unit_shapes
from vq_vae_gan_diffusion_torch.utils.profiling import (BF16_PEAK_FLOPS, F32_PEAK_FLOPS,
                                                        cuda_graph_ms, cuda_ms, hbm_bytes_per_s,
                                                        posterior_bound, ptxas_usage,
                                                        random_unit, shuffle_unit_bound,
                                                        smi_line)

CONFIG = "configs/inference_config_small.yml"
VQD_CONFIG = "configs/inference_config_vqdiffusion.yml"
VQO_CONFIG = "configs/inference_config_vqofficial.yml"
INT8KV_CONFIG = "configs/inference_config_int8kv.yml"
QUANT_MODES = ("int8", "int8kv", "int4", "int4kv")
# full width of the GPT prior in CONFIG, at --n-samples 16
L, C, H, B, N = 12, 1024, 16, 16, 256
# full width of the gaussian3d prior in VQD_CONFIG: state [B, N, 96, 1]
GAUSSIAN_DIM, STEPS = 96, 1000
# the discrete priors: VQ_Official's K = 1024 classes over 1000 steps
# (chain cut to 20), the transformer's K = 1025 over 100 steps
VQO_K, VQO_T, VQO_STEPS = 1024, 1000, 20
TVQ_K, TVQ_T, TRUNC_K = 1025, 100, int(1025 * 0.86)
# a transformer prior on a 2048-code VQVAE: K = 2049, wider than a staged row
WIDE_K = 2049
# stage-1 training: the benchmark workload of the root bench.py
TRAIN_CONFIG, TRAIN_B, TRAIN_STEPS = "configs/training_config_mnist.yml", 200, 10
TRAIN_EPOCHS = 4


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
            if "Function properties" in line or "Used" in line or "spill" in line:
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


def decode_stack_bound_ms(dtype: torch.dtype, name: str, quant: str | None = None
                          ) -> tuple[float, str]:
    """Least time of one call, averaged over the positions t = 0..N-1 of the
    main path: bytes (weights, with their scales when quantized, f32 params,
    x in and out, cache rows < t read, new rows written, each int8 cache row
    with its f32 scale) over the memory rate, or operations over the peak
    rate for the compute type ``dtype``, whichever is larger."""
    es = torch.tensor([], dtype=dtype).element_size()
    groups = {None: (0, 0), "int8": (1, 2), "int4": (8, 16)}[quant and quant[:4]]
    w_bytes = {None: es, "int8": 1, "int4": 0.5}[quant and quant[:4]]
    scales = L * 4 * (8 * C * groups[0] + C * groups[1])
    weights = L * 12 * C * C * w_bytes + scales + L * 13 * C * 4
    kv_es, row_extra = (1, 4) if quant in ("int8kv", "int4kv") else (es, 0)
    mean_t = (N - 1) / 2
    rows = L * B * (mean_t + 1)
    bytes_ = weights + 2 * B * C * 4 + rows * (2 * C * kv_es + 2 * row_extra)
    ops = 2 * B * L * 12 * C * C + 4 * B * L * mean_t * C
    peak = F32_PEAK_FLOPS if dtype == torch.float32 else BF16_PEAK_FLOPS
    by_bytes, by_ops = bytes_ / hbm_bytes_per_s(name), ops / peak
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


def one_kernel_a_call(label: str, tag: str, call, bound: float, card: str) -> None:
    """Fail unless each of 16 calls ``call(t)`` (t = 0, 16, .., 240) issues
    exactly one CUDA kernel, the decode stack's, as torch.profiler sees it:
    16 runtime launch calls in all (``cudaLaunch*``, ``cuLaunch*``, and no
    ``cudaMemcpy*``/``cudaMemset*``), each a ``cudaLaunchCooperativeKernel``,
    and every kernel record the decode stack's (the profiler can miss kernel
    records of a process's later sessions, so those are counted, not
    required). Prints the device time of a call (profiler) and the host's
    time to issue one (8 calls enqueued with no synchronise) beside the
    bound."""
    from torch.profiler import ProfilerActivity, profile

    ts = range(0, N, N // 16)
    for t in ts:
        call(t)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in ts[:8]:
        call(t)
    issue_ms = 1e3 * (time.perf_counter() - t0) / 8
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for t in ts:
            call(t)
        torch.cuda.synchronize()
    events = prof.key_averages()
    launches = {e.key: e.count for e in events if e.device_type.name == "CPU"
                and any(k in e.key for k in ("cudaLaunch", "cuLaunch", "cudaMemcpy",
                                             "cudaMemset", "cuMemcpy", "cuMemset"))}
    kernels = [e for e in events if e.device_type.name == "CUDA"]
    if (launches != {"cudaLaunchCooperativeKernel": len(ts)} or not kernels
            or any("decode_stack_kernel" not in e.key for e in kernels)):
        raise AssertionError(f"{tag}: {len(ts)} calls issued {launches}, kernel records "
                             f"{[(e.key, e.count) for e in kernels]}: expected one "
                             "cudaLaunchCooperativeKernel of decode_stack_kernel a call")
    recorded = sum(e.count for e in kernels)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 / recorded
    print(f"({label}) {tag}: 1 CUDA kernel a call ({len(ts)} cooperative launches for {len(ts)} "
          f"calls, {recorded} kernel records); device {device_ms:.4f} ms/call, host issue "
          f"{issue_ms:.4f} ms/call (t = 0, 16, .., 240), bound {bound:.4f} ms/call; {card}")


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
        one_kernel_a_call("c", str(dtype), lambda t: fused_decode_stack(x, packed, kv, t, n_head=H),
                          bound, card)
        print(f"(c) {dtype}: kernel {ms:.4f} ms/call, plain {plain_ms:.4f} ms/call, "
              f"bound {bound:.4f} ms/call by {bound_by} (mean over t = 0..{N - 1}); "
              f"kernel {ms * N:.2f} ms per {N}-token run; {card}")
        result[dtype] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound, "bound_by": bound_by}
        del packed, kv
    return result


def kernel_wrappers() -> dict:
    """Every kernel wrapper of the port by its kernel's name in the JSON line."""
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import (
        fused_posterior_sample, fused_posterior_sample_prng)
    from vq_vae_gan_diffusion_torch.ops.gpt_decode import (fused_decode_stack,
                                                           fused_decode_stack_q,
                                                           fused_decode_stack_qkv)
    from vq_vae_gan_diffusion_torch.ops.shuffle import fused_bottleneck, fused_downsample
    return {"gpt_decode_stack": fused_decode_stack, "gpt_decode_stack_q": fused_decode_stack_q,
            "gpt_decode_stack_qkv": fused_decode_stack_qkv, "shuffle_bottleneck": fused_bottleneck,
            "shuffle_downsample": fused_downsample, "discrete_posterior": fused_posterior_sample,
            "discrete_posterior_prng": fused_posterior_sample_prng}


def read_counts() -> dict:
    return {name: fn.launches for name, fn in kernel_wrappers().items()}


def reset_counts() -> None:
    for fn in kernel_wrappers().values():
        fn.launches = 0


def phase_main() -> int:
    """The main path through the user's entry point, cold then warm. Returns
    the kernel launches counted in the cold run."""
    from vq_vae_gan_diffusion_torch import generate
    from vq_vae_gan_diffusion_torch.ops.gpt_decode import fused_decode_stack

    argv = ["--config", CONFIG, "--n-samples", str(B), "--seed", "42", "--device", "cuda"]
    counted = None
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
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


def check_close(what: str, got: torch.Tensor, want: torch.Tensor, tol: float,
                scale: float | None = None) -> float:
    """max |got - want|, after failing unless finite and <= tol * scale;
    scale defaults to max(1, max |want|)."""
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = (got - want).abs().max().item()
    scale = max(1.0, want.abs().max().item()) if scale is None else scale
    if err > tol * scale:
        raise AssertionError(f"{what}: max abs err {err:.3e} above {tol} of scale {scale:.3f}")
    return err


def phase_units(card: str, h: int = N, w: int = GAUSSIAN_DIM, label: str = "f",
                kernel_reps: int = 20, plain_reps: int = 3) -> dict:
    """The bottleneck and downsample kernels against reference_bottleneck /
    reference_downsample at every distinct unit shape of the U-Net forward
    on a [B, h, w, 1] input (the gaussian3d state by default).

    Tolerance: max |kernel - plain| <= tol * max(1, max |plain|). f32, tol
    1e-4: both sum the same f32 products in other orders, over at most 9
    taps and 512 channels. bf16, tol 2e-2: both round x, the weights, the
    depthwise sums, the first pointwise output and the unit's output to
    bf16 at the same places, but a different f32 sum order can move one of
    them across a bf16 rounding boundary (one step, 2^-8 of it), which the
    next pointwise product carries on and the output's own rounding can
    widen to one step of the output's binade (2^-8 = 3.9e-3 of scale).

    Times are per call, at each shape, by CUDA events over back-to-back
    calls, printed with each kernel's tile plan; the returned means are
    per call over one forward's 39 bottleneck and 4 downsample calls.
    """
    from vq_vae_gan_diffusion_torch.ops.shuffle import (bottleneck_plan, downsample_plan,
                                                        fused_bottleneck, fused_downsample,
                                                        reference_bottleneck,
                                                        reference_downsample)
    units = unet_unit_shapes(h, w)
    counts: dict = {}
    for u in units:
        counts[u] = counts.get(u, 0) + 1
    if [k for k, *_ in units].count("K1") != 39 or len(units) != 43:
        raise AssertionError(f"unexpected unit list {units}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    result = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        tag = "f32" if dtype == torch.float32 else "bf16"
        acc = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0,
                   "ops_ms": 0.0, "bound_ms": 0.0, "calls": 0} for k in ("K1", "K2")}
        for (kind, uh, uw, c_in, c_out), count in counts.items():
            p = random_unit(kind, c_in, c_out, dtype, gen)
            x = torch.randn(B, uh, uw, c_in, generator=gen, device="cuda").to(dtype)
            kernel, plain = ((fused_bottleneck, reference_bottleneck) if kind == "K1"
                             else (fused_downsample, reference_downsample))
            what = f"{tag} {kind} {uh}x{uw} {c_in}->{c_out}"
            got, want = kernel(x, p), plain(x, p)
            torch.cuda.synchronize()
            err = check_close(what, got, want, tol)
            if kind == "K2":
                t_vec = torch.randn(B, c_in, generator=gen, device="cuda").to(dtype)
                got_t, want_t = kernel(x, p, t_vec), plain(x, p, t_vec)
                torch.cuda.synchronize()
                err_t = check_close(what + " t_vec", got_t, want_t, tol)
                print(f"({label}) {what} with the silu(x + t_vec) prologue: "
                      f"max abs err {err_t:.3e}")
                err = max(err, err_t)
            ms = cuda_ms(lambda: kernel(x, p), reps=kernel_reps)
            plain_ms = cuda_ms(lambda: plain(x, p), reps=plain_reps)
            by_bytes, by_ops = shuffle_unit_bound(kind, uh, uw, c_in, c_out, B, dtype, card)
            bound = max(by_bytes, by_ops)
            plan = (bottleneck_plan(B, uh, uw, c_in // 2, c_out // 2) if kind == "K1"
                    else downsample_plan(B, uh, uw, c_in, c_out // 2))
            print(f"({label}) {what} (x{count} a forward): max abs err {err:.3e}; "
                  f"kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, bound {bound:.4f} ms by "
                  f"{'bytes' if by_bytes >= by_ops else 'operations'}; {plan}")
            a = acc[kind]
            a["max_abs_err"] = max(a["max_abs_err"], err)
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("bytes_ms", by_bytes),
                             ("ops_ms", by_ops), ("bound_ms", bound)):
                a[key] += count * val
            a["calls"] += count
            del x, p, got, want
        for kind, a in acc.items():
            n = a.pop("calls")
            for key in ("ms", "plain_ms", "bound_ms"):
                a[key] /= n
            a["bound_by"] = "bytes" if a.pop("bytes_ms") >= a.pop("ops_ms") else "operations"
            print(f"({label}) {tag} {kind}: mean over one forward's {n} calls: "
                  f"kernel {a['ms']:.4f} ms, "
                  f"plain {a['plain_ms']:.4f} ms, bound {a['bound_ms']:.4f} ms by "
                  f"{a['bound_by']}; {n * a['ms']:.3f} ms a forward; {card}")
        result[dtype] = acc
    return result


def phase_other_shapes() -> None:
    """Both kernels against their plain versions in f32, tolerance 1e-4 as
    above, at shapes off the main path: every unit of the U-Net on the
    mnist config's state [16, 49, 96, 1] (odd grids, whose last row tile is
    short; a downsample there halves 49x96 to 25x48, its halo crossing the
    zero pad row past the image), the downsample's silu(x + t_vec) prologue
    on every odd grid, units whose last tile is short in rows and in
    columns, widths that fill no whole k-chunk or n-tile of the pointwise
    products or no 16-byte load (a downsample of 18 channels), and branches
    wider than one 256-column pass of the products (bottlenecks 512 -> 384
    and 100 -> 290 channels a branch, downsamples 300 -> 290 and
    600 -> 150). Then each kernel's C entry point returns -1, launching
    nothing, for shared memory short of its tile's or above a block's."""
    from vq_vae_gan_diffusion_torch.ops import shuffle
    from vq_vae_gan_diffusion_torch.ops.shuffle import (bottleneck_plan, downsample_plan,
                                                        fused_bottleneck, fused_downsample,
                                                        reference_bottleneck,
                                                        reference_downsample)
    cases = set(unet_unit_shapes(49, GAUSSIAN_DIM))
    if not any(kind == "K2" and h % 2 for kind, h, *_ in cases):
        raise AssertionError("the mnist geometry has no odd-grid downsample")
    cases |= {("K2", 98, 96, 32, 64), ("K1", 13, 7, 24, 12), ("K2", 14, 10, 20, 12),
              ("K2", 13, 7, 20, 12), ("K1", 37, 53, 64, 64), ("K1", 19, 29, 48, 40),
              ("K1", 9, 11, 1024, 768), ("K1", 7, 9, 200, 580), ("K2", 21, 45, 40, 24),
              ("K2", 30, 46, 48, 40), ("K2", 17, 27, 18, 26), ("K2", 9, 11, 300, 580),
              ("K2", 7, 9, 600, 300)}
    for kind in ("K1", "K2"):
        s = 2 if kind == "K2" else 1
        plans = []
        for k, h, w, c_in, c_out in cases:
            if k == kind:
                c = c_in // 2 if kind == "K1" else c_in        # one branch's input width
                plan = (bottleneck_plan if kind == "K1" else downsample_plan)(B, h, w, c, c_out // 2)
                plans.append((-(-h // s), -(-w // s), plan, max(c, c_out // 2)))
        if not (any(ho % p.th for ho, _, p, _ in plans) and any(wo % p.tw for _, wo, p, _ in plans)
                and any(c > 256 for *_, c in plans)):
            raise AssertionError(f"no {kind} case has a short last tile in rows, one in columns "
                                 "and a branch wider than 256 channels")
        for ho, wo, p, _ in plans if kind == "K2" else []:
            print(f"(f) K2 off-path plan on a {ho}x{wo} output grid: {p}")
    gen = torch.Generator(device="cuda").manual_seed(4)
    worst = 0.0
    for kind, h, w, c_in, c_out in sorted(cases):
        p = random_unit(kind, c_in, c_out, torch.float32, gen)
        x = torch.randn(B, h, w, c_in, generator=gen, device="cuda")
        kernel, plain = ((fused_bottleneck, reference_bottleneck) if kind == "K1"
                         else (fused_downsample, reference_downsample))
        what = f"f32 {kind} {h}x{w} {c_in}->{c_out}"
        got, want = kernel(x, p), plain(x, p)
        torch.cuda.synchronize()
        worst = max(worst, check_close(what, got, want, 1e-4))
        if kind == "K2" and (h % 2 or w % 2):
            # the halo of the last tile row or column crosses the zero pad
            # row or column past the image, where the prologue must not apply
            t_vec = torch.randn(B, c_in, generator=gen, device="cuda")
            got, want = kernel(x, p, t_vec), plain(x, p, t_vec)
            torch.cuda.synchronize()
            worst = max(worst, check_close(what + " t_vec", got, want, 1e-4))
    print(f"(f) f32, {len(cases)} shapes off the main path (mnist geometry 49x96 .. 4x6, "
          f"short last tiles, narrow and wide branches, the prologue on odd grids): "
          f"max abs err {worst:.3e}")
    # the C side refuses shared memory short of the tile's or above a
    # block's, before it launches anything
    lib, plan = shuffle._bind(), bottleneck_plan(B, 13, 7, 12, 6)
    x = torch.zeros(B, 13, 7, 24, device="cuda")
    out, params = torch.empty(B, 13, 7, 12, device="cuda"), random_unit("K1", 24, 12, x.dtype, gen)
    codes = [lib.shuffle_bottleneck_f32(x.data_ptr(), out.data_ptr(), shuffle._params(params), B,
                                        13, 7, 12, 6, plan.th, plan.tw, smem,
                                        torch.cuda.current_stream().cuda_stream)
             for smem in (plan.smem - 1, shuffle.SMEM_LIMIT + 1)]
    if codes != [-1, -1]:
        raise AssertionError(f"shuffle_bottleneck_f32 returned {codes} for short and excess "
                             "shared memory, not -1")
    print(f"(f) shuffle_bottleneck_f32 refuses {plan.smem - 1} and {shuffle.SMEM_LIMIT + 1} B "
          f"for a tile that needs {plan.smem} B")
    plan = downsample_plan(B, 13, 7, 20, 6)
    x = torch.zeros(B, 13, 7, 20, device="cuda")
    out, params = torch.empty(B, 7, 4, 12, device="cuda"), random_unit("K2", 20, 12, x.dtype, gen)
    codes = [lib.shuffle_downsample_f32(x.data_ptr(), None, out.data_ptr(), shuffle._params(params),
                                        B, 13, 7, 20, 6, plan.th, plan.tw, smem,
                                        torch.cuda.current_stream().cuda_stream)
             for smem in (plan.smem - 1, shuffle.SMEM_LIMIT + 1)]
    if codes != [-1, -1]:
        raise AssertionError(f"shuffle_downsample_f32 returned {codes} for short and excess "
                             "shared memory, not -1")
    print(f"(f) shuffle_downsample_f32 refuses {plan.smem - 1} and {shuffle.SMEM_LIMIT + 1} B "
          f"for a tile that needs {plan.smem} B")


def phase_vqdiffusion() -> dict:
    """The gaussian3d path through the user's entry point, cold then warm.
    Returns the launches of each kernel counted in the cold run."""
    from vq_vae_gan_diffusion_torch import generate

    argv = ["--config", VQD_CONFIG, "--n-samples", str(B), "--seed", "42", "--device", "cuda"]
    counted = None
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = generate.run(argv)
        total = time.perf_counter() - t0
        launches = read_counts()
        counted = launches if counted is None else counted
        idx, images = out["indices"], out["images"]
        if tuple(idx.shape) != (B, N) or int(idx.min()) < 0 or int(idx.max()) >= 1024:
            raise AssertionError(f"indices {tuple(idx.shape)} not [16, 256] in [0, 1024)")
        if tuple(images.shape) != (B, 256, 256, 3) or not torch.isfinite(images).all():
            raise AssertionError(f"images {tuple(images.shape)} not finite of [16,256,256,3]")
        want = {"gpt_decode_stack": 0, "gpt_decode_stack_q": 0, "gpt_decode_stack_qkv": 0,
                "shuffle_bottleneck": 39 * STEPS,
                "shuffle_downsample": 4 * STEPS, "discrete_posterior": 0,
                "discrete_posterior_prng": 0}
        if launches != want:
            raise AssertionError(f"launches {launches}, expected {want}")
        sec = out["seconds"]
        print(f"(g) {run}: {launches['shuffle_bottleneck']} bottleneck and "
              f"{launches['shuffle_downsample']} downsample launches; {STEPS}-step chain "
              f"{sec['sample']:.3f} s ({1e3 * sec['sample'] / STEPS:.3f} ms a reverse step: "
              f"one U-Net forward and the update); VQVAE decode {sec['decode']:.3f} s; total "
              f"{total:.2f} s; max memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{len(set(idx.flatten().tolist()))} distinct indices; grid {out['path']}")
    return counted


def phase_vqd_routes() -> None:
    """Kernel route against the unfused module at full width, on weights
    with non-trivial BatchNorm statistics (so a wrong fold shows): one U-Net
    forward within 1e-3 of max |module| (both true f32, TF32 off; the two
    sum every product in other orders through 43 units, and each unit
    carries the differences of the units before it), and a 20-step chain
    with the same noise giving at least 99% equal indices (the JAX
    package's bar, tests/test_shuffle_pallas.py)."""
    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.models.shuffle_infer import apply_folded, fold_unet
    from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import VQDiffusionComposite

    steps = 20
    cfg = load_config(VQD_CONFIG).replace_path("architecture.vqdiffusion.diffusion_steps", steps)
    comp = VQDiffusionComposite(cfg)
    comp.unet.init_weights(torch.Generator().manual_seed(5))
    bn_gen = torch.Generator().manual_seed(7)
    for m in comp.unet.modules():
        if isinstance(m, torch.nn.BatchNorm2d):
            m.weight.data = 1 + 0.1 * torch.randn(m.weight.shape, generator=bn_gen)
            m.bias.data = 0.1 * torch.randn(m.bias.shape, generator=bn_gen)
            m.running_mean = 0.1 * torch.randn(m.running_mean.shape, generator=bn_gen)
            m.running_var = 0.5 + torch.rand(m.running_var.shape, generator=bn_gen)
    comp = comp.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(6)
    x = torch.randn(B, N, GAUSSIAN_DIM, 1, generator=gen, device="cuda")
    t = torch.randint(0, steps, (B,), generator=gen, device="cuda")
    with torch.no_grad():
        ref = comp.unet(x, None, t)
    err = check_close("U-Net forward, kernel route vs module", apply_folded(
        fold_unet(comp.unet), x, t), ref, 1e-3, scale=ref.abs().max().item())
    print(f"(h) one U-Net forward [16, 256, 96, 1], kernel route vs fused_sampler False: "
          f"max abs err {err:.3e}, max |module| {ref.abs().max().item():.3f}")
    x_t = torch.randn(B, N, GAUSSIAN_DIM, 1, generator=gen, device="cuda")
    noise = [torch.randn_like(x_t) for _ in range(steps)]
    idx = {}
    for mode in ("packed", False):
        comp.fused_sampler = mode
        idx[mode] = comp.sample(B, x_T=x_t, step_noise=noise)
    agree = (idx["packed"] == idx[False]).float().mean().item()
    print(f"(h) {steps}-step chain, same noise: {100 * agree:.2f}% of {B} x {N} indices equal")
    if agree < 0.99:
        raise AssertionError(f"kernel and module routes agree on only {100 * agree:.2f}%")


def check_indices(what: str, got: torch.Tensor, scores: torch.Tensor) -> float:
    """The kernel's indices against the plain version's scores [B, N, K]:
    at least 99.9% of rows pick the plain argmax, and at every other row
    the plain version's two best scores lie within 1e-4 of each other and
    the kernel's pick scores within 1e-4 of the best. Returns the largest
    gap between the plain best score and the plain score of the kernel's
    pick (0 where they agree)."""
    if got.min().item() < 0 or got.max().item() >= scores.shape[-1]:
        raise AssertionError(f"{what}: indices outside [0, {scores.shape[-1]})")
    top2 = scores.topk(2, dim=-1).values
    differ = got != scores.argmax(-1)
    gap = (top2[..., 0] - scores.gather(-1, got[..., None])[..., 0]).max().item()
    agree = 1.0 - differ.float().mean().item()
    near = (top2[..., 0] - top2[..., 1])[differ]
    tie = near.max().item() if near.numel() else 0.0
    if agree < 0.999 or tie > 1e-4 or gap > 1e-4:
        raise AssertionError(f"{what}: {100 * agree:.3f}% of indices equal, top-2 gap at "
                             f"differing rows {tie:.3e}, score gap of the kernel's pick {gap:.3e}")
    return gap


def posterior_ptxas() -> None:
    """Each posterior_kernel instance's registers, stack frame and spills
    from the build log; fails on a stack frame or a spill."""
    from vq_vae_gan_diffusion_torch.ops._build import library_path
    usage = ptxas_usage(library_path("discrete_posterior").with_suffix(".log").read_text())
    kernels = {k: v for k, v in usage.items() if "posterior_kernel" in k}
    if len(kernels) != 8:
        raise AssertionError(f"expected 8 posterior_kernel instances in the build log, got "
                             f"{sorted(kernels)}")
    for mangled, (regs, stack, spill) in sorted(kernels.items()):
        prng, staged = re.search(r"Lb([01])ELb([01])E", mangled).groups()
        label = (f"posterior_kernel<{'bf16' if 'bfloat16' in mangled else 'float'}, "
                 f"{'prng' if prng == '1' else 'gumbel'}, "
                 f"{'staged' if staged == '1' else 'wide'}>")
        print(f"(i) ptxas {label}: {regs} registers, {stack} bytes stack frame, {spill} bytes "
              f"spill stores")
        if stack or spill:
            raise AssertionError(f"{label} has a stack frame or spills")


def posterior_edges(gen: torch.Generator) -> None:
    """(i), off the paths: B6 and B7 against their plain versions at K in
    {2, 129, 1025, 2048} (rows staged in shared memory) and {2049, 4097,
    2^20} (rows read from device memory), row counts that are no multiple of
    the rows a block, trunc_k in {0, 1, K-1, K}, f32 and bf16 logits, with
    three rows of all-equal logits and masked positions, by
    ``check_indices``."""
    from vq_vae_gan_diffusion_torch.diffusion.discrete import make_discrete_schedule
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import (
        fused_posterior_sample, fused_posterior_sample_prng, gather_posterior_coefs,
        gumbel_from_bits, gumbel_from_uniform, philox_bits, posterior_scores)
    steps = 100
    for k, b, n in ((2, 5, 201), (129, 3, 343), (1025, 2, 513), (2048, 1, 1023),
                    (2049, 2, 255), (4097, 1, 129), (2 ** 20, 1, 2)):
        km1 = k - 1
        sched = make_discrete_schedule(steps, k, 0.9).to("cuda")
        gumbel = gumbel_from_uniform(torch.rand(b, n, k, generator=gen, device="cuda"))
        seeds = torch.randint(-2 ** 31, 2 ** 31, (b, 2), dtype=torch.int32, generator=gen,
                              device="cuda")
        prng_gumbel = gumbel_from_bits(philox_bits(seeds, n, k))
        x_t = torch.randint(0, k, (b, n), generator=gen, device="cuda")
        x_t[:, ::5] = km1
        for dtype in (torch.float32, torch.bfloat16):
            logits = 3 * torch.randn(b, n, km1, generator=gen, device="cuda")
            logits[0, :min(3, n)] = 1.25                             # all-equal rows
            logits = logits.to(dtype)
            gap = 0.0
            for t in (1, steps - 1):
                coefs = gather_posterior_coefs(sched, torch.full((b,), t, device="cuda"), steps)
                for trunc_k in sorted({0, 1, km1, k}):
                    for name, fn, noise, g in (
                            ("discrete_posterior", fused_posterior_sample, gumbel, gumbel),
                            ("discrete_posterior_prng", fused_posterior_sample_prng, seeds,
                             prng_gumbel)):
                        got = fn(logits, x_t, coefs, noise, trunc_k=trunc_k)
                        torch.cuda.synchronize()
                        gap = max(gap, check_indices(
                            f"{name} [{b}, {n}, {km1}] {dtype} t={t} trunc_k={trunc_k}", got,
                            posterior_scores(logits, x_t, coefs, g, trunc_k)))
            print(f"(i) off the paths, logits [{b}, {n}, {km1}] {dtype}, B6 and B7, t in "
                  f"{{1, {steps - 1}}}, trunc_k in {sorted({0, 1, km1, k})}: checks pass, max "
                  f"score gap {gap:.3e}")


def posterior_wide_times(gen: torch.Generator, card: str) -> None:
    """(i) B6 and B7 at the wide prior's shape of (o), logits [16, 256, 2048]
    f32 (K = 2049, rows read from device memory), trunc_k 0 and 1762: ms a
    call issued one by one, the plain version's ms and the bound."""
    from vq_vae_gan_diffusion_torch.diffusion.discrete import make_discrete_schedule
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import (
        fused_posterior_sample, fused_posterior_sample_prng, gather_posterior_coefs,
        gumbel_from_uniform, reference_posterior_sample, reference_posterior_sample_prng)
    k, km1 = WIDE_K, WIDE_K - 1
    sched = make_discrete_schedule(TVQ_T, k, 0.9).to("cuda")
    logits = 3 * torch.randn(B, N, km1, generator=gen, device="cuda")
    gumbel = gumbel_from_uniform(torch.rand(B, N, k, generator=gen, device="cuda"))
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), dtype=torch.int32, generator=gen,
                          device="cuda")
    x_t = torch.randint(0, k, (B, N), generator=gen, device="cuda")
    coefs = gather_posterior_coefs(sched, torch.full((B,), TVQ_T // 2, device="cuda"), TVQ_T)
    for name, fn, plain, noise in (
            ("discrete_posterior", fused_posterior_sample, reference_posterior_sample, gumbel),
            ("discrete_posterior_prng", fused_posterior_sample_prng,
             reference_posterior_sample_prng, seeds)):
        for trunc_k in (0, int(k * 0.86)):
            ms = cuda_ms(lambda: fn(logits, x_t, coefs, noise, trunc_k=trunc_k), reps=50)
            plain_ms = cuda_ms(lambda: plain(logits, x_t, coefs, noise, trunc_k=trunc_k), reps=5)
            bound = max(posterior_bound(B, N, km1, torch.float32, name.endswith("prng"),
                                        trunc_k, card))
            print(f"(i) {name} logits [{B}, {N}, {km1}] float32 trunc_k {trunc_k} (rows read "
                  f"from device memory): kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                  f"{bound:.4f} ms; {card}")


def phase_posterior(card: str) -> dict:
    """(i): B6 and B7 against their plain versions, timing, and B7's
    distribution. Returns, per kernel, the JSON numbers at its path's shape
    (B6: VQ_Official's [16, 256, 1023] f32 logits; B7: the transformer's
    [16, 256, 1024]), trunc_k 0."""
    from vq_vae_gan_diffusion_torch.diffusion.discrete import make_discrete_schedule
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import (
        fused_posterior_sample, fused_posterior_sample_prng, gather_posterior_coefs,
        gumbel_from_bits, gumbel_from_uniform, philox_bits, posterior_log_probs,
        posterior_scores, reference_posterior_sample, reference_posterior_sample_prng)
    posterior_ptxas()
    gen = torch.Generator(device="cuda").manual_seed(8)
    result = {}
    for k, steps, ctt_T in ((VQO_K, VQO_T, 0.99999), (TVQ_K, TVQ_T, 0.9)):
        km1 = k - 1
        sched = make_discrete_schedule(steps, k, ctt_T).to("cuda")
        gumbel = gumbel_from_uniform(torch.rand(B, N, k, generator=gen, device="cuda"))
        seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), dtype=torch.int32, generator=gen,
                              device="cuda")
        prng_gumbel = gumbel_from_bits(philox_bits(seeds, N, k))
        x_t = torch.randint(0, k, (B, N), generator=gen, device="cuda")
        x_t[:, ::5] = km1                                          # masked positions
        for dtype in (torch.float32, torch.bfloat16):
            logits = (3 * torch.randn(B, N, km1, generator=gen, device="cuda")).to(dtype)
            gaps = {"discrete_posterior": 0.0, "discrete_posterior_prng": 0.0}
            for t in (0, 1, steps // 2, steps - 1):
                coefs = gather_posterior_coefs(sched, torch.full((B,), t, device="cuda"), steps)
                for trunc_k in (0, TRUNC_K):
                    for name, fn, noise, g in (
                            ("discrete_posterior", fused_posterior_sample, gumbel, gumbel),
                            ("discrete_posterior_prng", fused_posterior_sample_prng, seeds,
                             prng_gumbel)):
                        got = fn(logits, x_t, coefs, noise, trunc_k=trunc_k)
                        torch.cuda.synchronize()
                        what = f"{name} K={k} {dtype} t={t} trunc_k={trunc_k}"
                        gaps[name] = max(gaps[name], check_indices(
                            what, got, posterior_scores(logits, x_t, coefs, g, trunc_k)))
            coefs = gather_posterior_coefs(sched, torch.full((B,), steps // 2, device="cuda"),
                                           steps)
            for name, fn, plain, noise in (
                    ("discrete_posterior", fused_posterior_sample, reference_posterior_sample,
                     gumbel),
                    ("discrete_posterior_prng", fused_posterior_sample_prng,
                     reference_posterior_sample_prng, seeds)):
                for trunc_k in (0, TRUNC_K):
                    ms = cuda_ms(lambda: fn(logits, x_t, coefs, noise, trunc_k=trunc_k), reps=50)
                    graph_ms = cuda_graph_ms(lambda: fn(logits, x_t, coefs, noise,
                                                        trunc_k=trunc_k))
                    plain_ms = cuda_ms(lambda: plain(logits, x_t, coefs, noise, trunc_k=trunc_k),
                                       reps=5)
                    by_bytes, by_ops = posterior_bound(B, N, km1, dtype, name.endswith("prng"),
                                                       trunc_k, card)
                    bound = max(by_bytes, by_ops)
                    bound_by = "bytes" if by_bytes >= by_ops else "operations"
                    print(f"(i) {name} logits [{B}, {N}, {km1}] {dtype} trunc_k {trunc_k}: "
                          f"checks at 4 t x 2 trunc_k pass, max score gap {gaps[name]:.3e}; kernel "
                          f"{ms:.4f} ms ({graph_ms:.4f} of device time in a CUDA graph), plain "
                          f"{plain_ms:.4f} ms, bound {bound:.4f} ms by {bound_by}; {card}")
                    main_k = VQO_K if name == "discrete_posterior" else TVQ_K
                    if k == main_k and dtype == torch.float32 and trunc_k == 0:
                        result[name] = {"max_abs_err": gaps[name], "ms": ms, "plain_ms": plain_ms,
                                        "bound_ms": bound, "bound_by": bound_by}
            del logits

    posterior_edges(gen)
    posterior_wide_times(gen, card)

    # B7's distribution: one row's logits everywhere, 256 calls of 16 seed pairs
    k, km1 = TVQ_K, TVQ_K - 1
    sched = make_discrete_schedule(TVQ_T, k, 0.9).to("cuda")
    logits = torch.randn(1, 1, km1, generator=gen, device="cuda").expand(B, N, km1).contiguous()
    x_t = torch.full((B, N), 7, device="cuda")
    coefs = gather_posterior_coefs(sched, torch.full((B,), TVQ_T // 2, device="cuda"), TVQ_T)
    counts = torch.zeros(k, dtype=torch.float64, device="cuda")
    calls = 256
    for _ in range(calls):
        seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), dtype=torch.int32, generator=gen,
                              device="cuda")
        got = fused_posterior_sample_prng(logits, x_t, coefs, seeds)
        counts += torch.bincount(got.flatten(), minlength=k).double()
    p = torch.softmax(posterior_log_probs(logits[:1, :1], x_t[:1, :1], coefs[:1])[0, 0].double(),
                      dim=-1)
    tv = 0.5 * (counts / counts.sum() - p).abs().sum().item()
    print(f"(i) discrete_posterior_prng: {calls * B} seeds, {int(counts.sum().item())} draws of "
          f"one row's posterior over {k} classes: total variation {tv:.4f} against softmax(ev)")
    if tv >= 0.02:
        raise AssertionError(f"prng samples stray from the posterior: total variation {tv:.4f}")
    return result


def phase_vqofficial(card: str) -> dict:
    """(j): the VQ_Official path through the user's entry point, cold then
    warm, the unit shapes of its U-Net, and the posterior kernel against
    plain ops over a 20-step chain. Returns the launches of the cold run."""
    from vq_vae_gan_diffusion_torch import generate
    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import VQDiffusionComposite
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import gumbel_from_uniform

    steps_path = "architecture.vqdiffusion.sampling_steps"
    argv = ["--config", VQO_CONFIG, "--n-samples", str(B), "--seed", "42", "--device", "cuda"]
    counted = None
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = generate.run(argv, overrides={steps_path: VQO_STEPS})
        total = time.perf_counter() - t0
        launches = read_counts()
        counted = launches if counted is None else counted
        idx, images = out["indices"], out["images"]
        if tuple(idx.shape) != (B, N) or int(idx.min()) < 0 or int(idx.max()) >= VQO_K:
            raise AssertionError(f"indices {tuple(idx.shape)} not [16, 256] in [0, 1024)")
        if tuple(images.shape) != (B, 256, 256, 3) or not torch.isfinite(images).all():
            raise AssertionError(f"images {tuple(images.shape)} not finite of [16,256,256,3]")
        want = {"gpt_decode_stack": 0, "gpt_decode_stack_q": 0, "gpt_decode_stack_qkv": 0,
                "shuffle_bottleneck": 39 * VQO_STEPS,
                "shuffle_downsample": 4 * VQO_STEPS, "discrete_posterior": VQO_STEPS - 1,
                "discrete_posterior_prng": 0}
        if launches != want:
            raise AssertionError(f"launches {launches}, expected {want}")
        sec = out["seconds"]
        print(f"(j) {run}: {launches['discrete_posterior']} posterior, "
              f"{launches['shuffle_bottleneck']} bottleneck and "
              f"{launches['shuffle_downsample']} downsample launches; {VQO_STEPS}-step chain "
              f"{sec['sample']:.3f} s ({1e3 * sec['sample'] / VQO_STEPS:.3f} ms a reverse step); "
              f"VQVAE decode {sec['decode']:.3f} s; total {total:.2f} s; max memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{len(set(idx.flatten().tolist()))} distinct indices; grid {out['path']}; {card}")

    phase_units(card, h=VQO_K, w=N, label="j", kernel_reps=5, plain_reps=1)

    cfg = load_config(VQO_CONFIG).replace_path(steps_path, VQO_STEPS)
    comp = VQDiffusionComposite(cfg)
    comp.unet.init_weights(torch.Generator().manual_seed(9))
    comp = comp.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(10)
    shape = (B, N, VQO_K)
    u = torch.rand(shape, generator=gen, device="cuda")
    gumbel = [gumbel_from_uniform(torch.rand(shape, generator=gen, device="cuda"))
              for _ in range(VQO_STEPS)]
    idx = {}
    for mode in (True, False):
        comp.fused_posterior = mode
        idx[mode] = comp.sample(B, init_uniform=u, step_gumbel=gumbel)
    agree = (idx[True] == idx[False]).float().mean().item()
    print(f"(j) {VQO_STEPS}-step chain, same noise, fused_posterior on against off: "
          f"{100 * agree:.2f}% of {B} x {N} indices equal")
    if agree < 0.99:
        raise AssertionError(f"posterior kernel and plain ops agree on only {100 * agree:.2f}%")
    return counted


def phase_transformer(card: str) -> dict:
    """(k): the transformer prior's samplers at full width; returns the
    launches of each run by its label."""
    from vq_vae_gan_diffusion_torch.models.transformer_vq_diffusion import (
        TransformerVQDiffusion)

    tvq = TransformerVQDiffusion(codebook_size=1024, seq_len=N, diffusion_steps=TVQ_T,
                                 embedding_dim=512, num_layers=4, num_heads=8)
    tvq.predictor.init_weights(torch.Generator().manual_seed(11))
    tvq = tvq.cuda().eval()
    none = {name: 0 for name in kernel_wrappers()}
    runs = (("sample, plain ops", "sample", False, {}),
            ("sample, B6", "sample", True, {"discrete_posterior": TVQ_T - 1}),
            ("fast_sample, B6 at trunc_k 881", "fast_sample", True,
             {"discrete_posterior": (TVQ_T - 1) // 4}),
            ("sample, prng (B7)", "sample", "prng", {"discrete_posterior_prng": TVQ_T - 1}))
    counted = {}
    for label, method, mode, expect in runs:
        tvq.diffusion.fused_posterior = mode
        getattr(tvq, method)(B, generator=torch.Generator(device="cuda").manual_seed(12))
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        idx = getattr(tvq, method)(B, generator=torch.Generator(device="cuda").manual_seed(12))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = read_counts()
        if launches != dict(none, **expect):
            raise AssertionError(f"{label}: launches {launches}, expected {expect}")
        if tuple(idx.shape) != (B, 16, 16) or int(idx.min()) < 0 or int(idx.max()) > 1023:
            raise AssertionError(f"{label}: indices {tuple(idx.shape)} not [16, 16, 16] "
                                 "in [0, 1023]")
        counted[label] = launches
        n_steps = TVQ_T if method == "sample" else (TVQ_T - 1) // 4 + 1
        print(f"(k) {label}: {sum(launches.values())} kernel launches; {n_steps}-step chain "
              f"{sec:.4f} s warm ({1e3 * sec / n_steps:.3f} ms a reverse step); {card}")
    return counted


def quant_gpt(gen_seed: int, device: str = "cuda"):
    """The full-width GPT prior with N(0, 0.02) weights and LayerNorm affines
    and biases perturbed by N(0, 0.1^2), so that every term of the stack
    matters."""
    from vq_vae_gan_diffusion_torch.models.mingpt import GPT

    gpt = GPT(vocab_size=1024, block_size=512, n_layer=L, n_head=H, n_embd=C)
    gen = torch.Generator().manual_seed(gen_seed)
    gpt.init_weights(gen)
    with torch.no_grad():
        for name, prm in gpt.named_parameters():
            if prm.dim() == 1:
                prm.add_(0.1 * torch.randn(prm.shape, generator=gen))
    return gpt.to(device).eval()


def quant_cache(quant: str, dtype: torch.dtype, gen: torch.Generator):
    """A pre-filled cache: normal values in ``dtype``, or for the *kv modes
    int8 levels in [-127, 127] with per-row scales in [0.005, 0.02]."""
    if not quant.endswith("kv"):
        return torch.randn(L, B, N, 2 * C, generator=gen, device="cuda").to(dtype), None
    kv = torch.randint(-127, 128, (L, B, N, 2 * C), generator=gen, device="cuda",
                       dtype=torch.int8)
    sc = 0.005 + 0.015 * torch.rand(L, B, N, 2, generator=gen, device="cuda")
    return kv, sc


def check_int8_rows(what: str, got: tuple, want: tuple, dtype: torch.dtype) -> float:
    """The new int8 cache rows and their scales, (x_out, kv_new, sc_new) of
    the kernel against the plain version. f32: levels at most one apart and
    at least 99.9% equal, scales within 1e-5 relative. bf16: the rows
    dequantized within 2e-2 of max(1, max |plain|) and the scales within
    2e-2 relative, as (c) holds a bf16 cache. Returns the share of equal
    levels."""
    diff = (got[1].int() - want[1].int()).abs()
    same = (diff == 0).float().mean().item()
    if dtype == torch.float32:
        if diff.max().item() > 1 or same < 0.999:
            raise AssertionError(f"{what}: levels up to {diff.max().item()} apart, "
                                 f"{100 * same:.3f}% equal")
        check_close(what + " scales", got[2], want[2], 1e-5, scale=want[2].abs().min().item())
        return same
    c = got[1].shape[-1] // 2

    def dequant(out):
        return torch.cat([out[1][..., :c] * out[2][..., :1], out[1][..., c:] * out[2][..., 1:]], -1)
    check_close(what + " dequantized", dequant(got), dequant(want), 2e-2)
    check_close(what + " scales", got[2], want[2], 2e-2, scale=want[2].abs().min().item())
    return same


def phase_quant_kernels(card: str) -> dict:
    """(l): B2b and B2c against reference_decode_stack at full width.

    Tolerances as in (c): x_out within 1e-4 (f32) or 2e-2 (bf16) of max(1,
    max |plain|); a float cache's new rows likewise. The new int8 rows in
    f32: a k or v on a rounding boundary of its level may round either way
    after another f32 sum order, so at most one level apart and at least
    99.9% equal; their scales (max |.| / 127) within 1e-5 relative. In bf16
    the LayerNorm outputs are rounded to bf16 after sums taken in other
    orders, and a value on a bf16 boundary rounds either way (2^-8 of it):
    k and v move by about a tenth of an int8 step, and a first run found
    only 93.96% of levels equal (all within one). So the bf16 rows are held
    as (c) holds a bf16 cache (check_int8_rows). Returns, per mode and
    compute type, the JSON numbers."""
    from vq_vae_gan_diffusion_torch.ops.gpt_decode import (fused_decode_stack_q,
                                                           fused_decode_stack_qkv,
                                                           pack_decode_params,
                                                           reference_decode_stack)
    gpt = quant_gpt(13)
    for fmt in ("int8", "int4"):   # the card packs what the CPU (and JAX) packs
        on_card = pack_decode_params(gpt, quant=fmt)
        on_cpu = pack_decode_params(quant_gpt(13, "cpu"), quant=fmt)
        differ = {k: int((on_card[k].cpu() != v).sum()) for k, v in on_cpu.items()}
        print(f"(l) {fmt} levels and scales packed on the card against the CPU: "
              f"{sum(differ.values())} of {sum(v.numel() for v in on_cpu.values())} differ")
        if any(differ.values()):
            raise AssertionError(f"{fmt} packing differs between devices: {differ}")
        del on_card, on_cpu
    gen = torch.Generator(device="cuda").manual_seed(14)
    result = {}
    for quant in QUANT_MODES:
        quant_kv = quant.endswith("kv")
        for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            packed = pack_decode_params(gpt, dtype, quant)
            x = torch.randn(B, C, generator=gen, device="cuda")
            kv, sc = quant_cache(quant, dtype, gen)
            if quant_kv:
                def kernel(t):
                    return fused_decode_stack_qkv(x, packed, kv, sc, t, n_head=H,
                                                  compute_dtype=dtype)

                def plain(t):
                    return reference_decode_stack(x, packed, kv, t, n_head=H, kv_scales=sc,
                                                  compute_dtype=dtype)
            else:
                def kernel(t):
                    return fused_decode_stack_q(x, packed, kv, t, n_head=H)

                def plain(t):
                    return reference_decode_stack(x, packed, kv, t, n_head=H)
            tag = f"{quant} {str(dtype)[6:]}"
            worst, same = 0.0, 1.0
            for t in (0, 1, 63, 64, 255):
                got, want = kernel(t), plain(t)
                torch.cuda.synchronize()
                worst = max(worst, check_close(f"{tag} t={t} x_out", got[0], want[0], tol))
                if quant_kv:
                    same = min(same, check_int8_rows(f"{tag} t={t} kv_new", got, want, dtype))
                else:
                    check_close(f"{tag} t={t} kv_new", got[1], want[1], tol)
            ms = cuda_ms(lambda: [kernel(t) for t in range(N)]) / N
            plain_ts = range(4, N, 8)   # 32 positions evenly spread, mean t 128
            plain_ms = cuda_ms(lambda: [plain(t) for t in plain_ts]) / len(plain_ts)
            bound, bound_by = decode_stack_bound_ms(dtype, card, quant)
            one_kernel_a_call("l", tag, kernel, bound, card)
            print(f"(l) {tag}: t in (0, 1, 63, 64, 255) max abs err {worst:.3e}"
                  + (f", new int8 rows {100 * same:.3f}% equal" if quant_kv else "")
                  + f"; kernel {ms:.4f} ms/call (mean over t = 0..{N - 1}), plain "
                  f"{plain_ms:.4f} ms/call (32 t), bound {bound:.4f} ms/call by {bound_by}; {card}")
            result[(quant, dtype)] = {"max_abs_err": worst, "ms": ms, "plain_ms": plain_ms,
                                      "bound_ms": bound, "bound_by": bound_by}
            del packed, kv, sc
    return result


def phase_int8kv_path() -> dict:
    """(m): the int8kv GPT path through the user's entry point, cold then
    warm, then sample_tokens under int8, int4 and int4kv. Returns the
    launches of the cold CLI run and of each sample_tokens run."""
    from vq_vae_gan_diffusion_torch import generate
    from vq_vae_gan_diffusion_torch.models.mingpt import sample_tokens

    none = {name: 0 for name in kernel_wrappers()}
    argv = ["--config", INT8KV_CONFIG, "--n-samples", str(B), "--seed", "42", "--device", "cuda"]
    counted = {}
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = generate.run(argv)
        total = time.perf_counter() - t0
        launches = read_counts()
        counted.setdefault("int8kv", launches)
        tokens, images = out["tokens"], out["images"]
        if tuple(tokens.shape) != (B, 256) or int(tokens.min()) < 0 or int(tokens.max()) >= 1024:
            raise AssertionError(f"tokens {tuple(tokens.shape)} not [16, 256] in [0, 1024)")
        if tuple(images.shape) != (B, 256, 256, 3) or not torch.isfinite(images).all():
            raise AssertionError(f"images {tuple(images.shape)} not finite of [16,256,256,3]")
        if launches != dict(none, gpt_decode_stack_qkv=256):
            raise AssertionError(f"launches {launches}, expected 256 of gpt_decode_stack_qkv")
        sec = out["seconds"]
        print(f"(m) int8kv {run}: {launches['gpt_decode_stack_qkv']} B2c launches, 0 B1; "
              f"decode loop {1e3 * sec['sample'] / 256:.3f} ms/token, "
              f"{B * 256 / sec['sample']:.1f} tokens/s; VQVAE decode {sec['decode']:.3f} s; "
              f"total {total:.2f} s; max memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; grid {out['path']}")

    gpt = quant_gpt(15)
    prefix = torch.zeros(B, 1, dtype=torch.long, device="cuda")
    for quant, name in (("int8", "gpt_decode_stack_q"), ("int4", "gpt_decode_stack_q"),
                        ("int4kv", "gpt_decode_stack_qkv")):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        tokens = sample_tokens(gpt, prefix, 1, 256, quant=quant,
                               generator=torch.Generator(device="cuda").manual_seed(16))
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = read_counts()
        counted[quant] = launches
        if launches != dict(none, **{name: 256}):
            raise AssertionError(f"{quant}: launches {launches}, expected 256 of {name}")
        if tuple(tokens.shape) != (B, 256) or int(tokens.min()) < 0 or int(tokens.max()) >= 1024:
            raise AssertionError(f"{quant}: tokens {tuple(tokens.shape)} not [16, 256] "
                                 "in [0, 1024)")
        print(f"(m) sample_tokens quant={quant}: 256 launches of {name}; "
              f"{1e3 * sec / 256:.3f} ms/token (packing included), {B * 256 / sec:.1f} tokens/s")
    return counted


def phase_int8kv_routes() -> None:
    """(n): int8kv through the kernels against the plain route, the model on
    the CPU, where the wrapper takes the plain version: 32 tokens at
    temperature 1e-4, top-k 100, after the same 9-token prefix and with the
    same noise (uniforms drawn once on the CPU and handed to both). Both
    routes step through one sequence, the plain route's own draws
    (``fused_step``), and at least 99% of their draws must be equal.

    Free-running, each route would follow its own draws, and one differing
    draw sends its row down another sequence: each call agrees to about
    1e-5 ((l)), but the two sum k and v in other orders, so a few levels of
    each new int8 cache row round the other way, every later position reads
    them, and the logits drift apart by a few 1e-3 (printed), which decides
    a near tie."""
    from vq_vae_gan_diffusion_torch.models.mingpt import categorical, fused_step, top_k_filter

    prefix = torch.cat([torch.zeros(B, 1, dtype=torch.long),
                        torch.randint(0, 1024, (B, 8), generator=torch.Generator().manual_seed(18))],
                       1)
    steps, temperature = 32, 1e-4
    total = prefix.shape[1] + steps - 1
    uniform = torch.rand(total, B, 1024, generator=torch.Generator().manual_seed(19))
    routes = {dev: fused_step(quant_gpt(17, dev), B, total, temperature, quant="int8kv")
              for dev in ("cpu", "cuda")}
    got, gaps, drift = {"cpu": [], "cuda": []}, [], 0.0
    token = prefix[:, 0]
    t0 = time.perf_counter()
    for t in range(total):
        token_in = prefix[:, t] if t < prefix.shape[1] else token
        raw = {dev: step(token_in.to(dev), t).cpu() for dev, step in routes.items()}
        drift = max(drift, temperature * (raw["cpu"] - raw["cuda"]).abs().max().item())
        draw = {dev: categorical(top_k_filter(lg, 100), None, uniform[t])
                for dev, lg in raw.items()}
        token = draw["cpu"]
        if t >= prefix.shape[1] - 1:
            for dev in got:
                got[dev].append(draw[dev])
            top2 = raw["cpu"].topk(2, -1).values * temperature
            gaps.append(top2[:, 0] - top2[:, 1])
    sec = time.perf_counter() - t0
    plain, kernel = torch.stack(got["cpu"], 1), torch.stack(got["cuda"], 1)
    differ = (kernel != plain).nonzero().tolist()
    agree = 1.0 - len(differ) / plain.numel()
    gap = torch.stack(gaps, 1)
    print(f"(n) int8kv kernel route vs plain route (CPU; {sec:.1f} s for both), {B} x {steps} "
          f"tokens at temperature {temperature}, same prefix, sequence and noise: "
          f"{100 * agree:.2f}% equal; mismatches (row, position, plain top-2 logit gap) "
          f"{[(r, p, round(gap[r, p].item(), 6)) for r, p in differ]}; largest logit "
          f"difference {drift:.3e}")
    if agree < 0.99:
        raise AssertionError(f"int8kv kernel and plain routes agree on only {100 * agree:.2f}%")


def train_cli_run(log_dir: str) -> dict:
    """(o) the train CLI in debug mode, two full-width steps on the card;
    then TRAIN_EPOCHS epochs, each epoch's time split as the loop records
    it. Returns the epochs' rows and the warm epochs' images/s."""
    import glob
    import os

    from vq_vae_gan_diffusion_torch.train import cli

    out = cli.run(["--config", TRAIN_CONFIG, "--debug"], overrides={"trainer.log_dir": log_dir})
    with open(os.path.join(out["run_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ckpts = glob.glob(os.path.join(out["run_dir"], "ckpt", "step_*.pth"))
    if [r["step"] for r in rows[:2]] != [1, 2] or not all(
            math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"(o) metrics.jsonl rows {rows}")
    if len(ckpts) != 1 or torch.load(ckpts[0], weights_only=True)["step"] != 2:
        raise AssertionError(f"(o) checkpoints {ckpts}")
    print(f"(o) train CLI --debug on the card: {len(rows)} metrics.jsonl rows, last step "
          f"{rows[1]}; checkpoint {os.path.basename(ckpts[0])}")
    out = cli.run(["--config", TRAIN_CONFIG, "--epochs", str(TRAIN_EPOCHS)],
                  overrides={"trainer.log_dir": log_dir})
    with open(os.path.join(out["run_dir"], "metrics.jsonl")) as f:
        epochs = [r for r in map(json.loads, f) if "epoch_time_s" in r]
    if len(epochs) != TRAIN_EPOCHS:
        raise AssertionError(f"(o) {len(epochs)} epoch rows in metrics.jsonl")
    for i, e in enumerate(epochs):
        print(f"(o) train CLI epoch {i} ({'setup included' if i == 0 else 'warm'}): "
              f"{e['steps']} steps at batch {TRAIN_B} of synthetic images decoded on the host "
              f"as it goes, {e['epoch_time_s']:.3f} s, {e['images_per_sec']:.1f} images/s; "
              f"host in the loader {e['loader_s']:.3f} s, in the artifacts "
              f"{e['artifact_s']:.3f} s, steps and the device's tail {e['step_s']:.3f} s")
    warm = epochs[1:]
    rate = sum(e["steps"] for e in warm) * TRAIN_B / sum(e["epoch_time_s"] for e in warm)
    print(f"(o) train CLI, epochs 1-{TRAIN_EPOCHS - 1}: {rate:.1f} images/s")
    return {"epochs": epochs, "warm_images_per_s": rate}


def train_step_times(worker, batch: torch.Tensor, card: str) -> dict:
    """(o) warm ms a train_step at full width before and after disc_start,
    peak device memory, and a torch.profiler window of three steps."""
    from torch.profiler import ProfilerActivity, profile
    from torch.utils.flop_counter import FlopCounterMode

    state = worker.state

    def steps(n: int) -> dict:
        for _ in range(n):
            _, metrics = worker.train_step(state, batch)
        torch.cuda.synchronize()
        return {k: float(v) for k, v in metrics.items()}

    def timed(n: int) -> tuple:
        steps(2)
        t0 = time.perf_counter()
        metrics = steps(n)
        return 1e3 * (time.perf_counter() - t0) / n, metrics

    torch.cuda.reset_peak_memory_stats()
    ms_before, m_before = timed(TRAIN_STEPS)
    state.step = worker.disc_start
    ms_after, m_after = timed(TRAIN_STEPS)
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    if m_before["disc_factor"] != 0.0 or m_after["disc_factor"] != 1.0:
        raise AssertionError(f"(o) disc_factor {m_before['disc_factor']}, {m_after['disc_factor']}")
    if not (m_after["lambda"] > 0 and all(math.isfinite(v) for v in m_after.values())):
        raise AssertionError(f"(o) metrics after disc_start {m_after}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps(3)
        window_ms = 1e3 * (time.perf_counter() - t0)
    # CUDA-side events less the ranges the optimizer annotates (they
    # overlap its kernels)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    with FlopCounterMode(display=False) as flops:
        steps(1)
    bound_ms = 1e3 * flops.get_total_flops() / F32_PEAK_FLOPS
    print(f"(o) train_step [{TRAIN_B}, 28, 28, 1] f32 warm: {ms_before:.3f} ms before disc_start, "
          f"{ms_after:.3f} ms after ({1e3 * TRAIN_B / ms_after:.1f} images/s), peak "
          f"{peak:.3f} GiB; profiled 3 steps: device {dev_ms / 3:.3f} ms a step, busy "
          f"{100 * dev_ms / window_ms:.1f}% of {window_ms / 3:.3f} ms; "
          f"{flops.get_total_flops() / 1e12:.4f} TFLOP a step, bound {bound_ms:.3f} ms at the "
          f"f32 peak; {card}")
    print(f"(o) metrics after disc_start: {m_after}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        print(f"(o)   {e.self_device_time_total / 3e3:9.3f} ms a step "
              f"{e.count / 3:6.1f} launches  {e.key[:90]}")
    return {"config": TRAIN_CONFIG, "batch": TRAIN_B, "dtype": "float32",
            "ms_before_disc_start": ms_before, "ms_after_disc_start": ms_after,
            "images_per_s": 1e3 * TRAIN_B / ms_after, "peak_gib": peak,
            "device_ms_per_step": dev_ms / 3, "device_busy_share": dev_ms / window_ms,
            "tflop_per_step": flops.get_total_flops() / 1e12, "bound_ms": bound_ms,
            "card": card}


def train_layer_times(worker, batch: torch.Tensor, card: str) -> dict:
    """(o) ms of the step's layers alone at its shapes, by CUDA events: the
    VQVAE forward and backward, LPIPS forward and backward to the decoded
    image, one discriminator call forward and backward, both Adam steps."""
    state = worker.state
    decoded = state.vqvae(batch)[0].detach()

    def vqvae():
        out, _, q_loss = state.vqvae(batch)
        (out.square().mean() + q_loss).backward()

    def lpips():
        worker.lpips(batch, decoded.clone().requires_grad_(True)).mean().backward()

    def disc():
        state.disc(decoded.clone().requires_grad_(True)).mean().backward()

    def adam():
        state.opt_g.step()
        state.opt_d.step()
    times = {name: cuda_ms(fn, reps=5) for name, fn in
             (("vqvae", vqvae), ("lpips", lpips), ("discriminator", disc), ("adam", adam))}
    print(f"(o) the step's layers alone at batch {TRAIN_B}: " + ", ".join(
        f"{name} {ms:.3f} ms" for name, ms in times.items()) + f"; {card}")
    return times


def card_against_cpu(cfg, log_dir: str, batch, card: str) -> None:
    """(o) one step at full width from the same seeded weights and batch on
    the card and on the CPU in f32, and on the CPU in float64 (the step's
    modules and batch cast to float64) as the reference of both, all at
    disc_start. Leaf by leaf: a leaf whose reference gradient is below 1e-5
    of the step's largest is rounding; each other leaf's card gradient lies
    no further from the reference than the larger of twice the CPU's
    distance and 1e-4 of the leaf's largest entry, and at least 99% of its
    parameters within lr / 10
    of the CPU's after the step; every parameter within 2 lr; running
    statistics within 1e-4."""
    from vq_vae_gan_diffusion_torch.train.vqgan_worker import VQGANVQVAEWorker

    runs = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        w = VQGANVQVAEWorker(cfg, log_dir, device=device)
        state = w.init_state()
        state.step = w.disc_start
        for module in (state.vqvae, state.disc, w.lpips):
            module.to(dtype)
        x = torch.from_numpy(batch).to(device, dtype)
        with torch.no_grad():
            idx = state.vqvae.encode(x)[1].cpu()
        t0 = time.perf_counter()
        _, metrics = w.train_step(state, x)
        metrics = {k: float(v) for k, v in metrics.items()}
        sec = time.perf_counter() - t0
        params, grads = {}, {}
        for part, module in (("vqvae", state.vqvae), ("disc", state.disc)):
            params.update({f"{part}.{k}": v.cpu() for k, v in module.state_dict().items()})
            grads.update({f"{part}.{k}": p.grad.cpu().double()
                          for k, p in module.named_parameters()})
        runs[device, dtype] = (idx, metrics, params, grads, sec)
    (gi, gm, gp, gg, _), (ci, cm, cp, cg, csec) = runs["cuda", torch.float32], \
        runs["cpu", torch.float32]
    ref = runs["cpu", torch.float64][3]
    same = (gi == ci).double().mean().item()
    same64 = (gi == runs["cpu", torch.float64][0]).double().mean().item()
    rel = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-6) for k in cm}
    lr = float(cfg.trainer.vqvae.learning_rate)
    top = max(float(g.abs().max()) for g in ref.values())
    live = {k for k, g in ref.items() if float(g.abs().max()) > 1e-5 * top}
    err = {k: (float((gg[k] - g).abs().max()) / float(g.abs().max()),
               float((cg[k] - g).abs().max()) / float(g.abs().max())) for k, g in ref.items()
           if k in live}
    off = {k: e for k, e in err.items() if e[0] > max(2 * e[1], 1e-4)}
    diffs = {k: (gp[k].double() - cp[k].double()).abs() for k in cp if "num_batches" not in k}
    stats = max(float(d.max()) for k, d in diffs.items() if "running" in k)
    worst = max(float(d.max()) for k, d in diffs.items() if "running" not in k)
    near = {k: (diffs[k] <= lr / 10).double().mean().item() for k in live}
    p_worst = min(near, key=near.get)
    print(f"(o) one step on the card against the CPU ({csec:.1f} s on the CPU): {100 * same:.3f}% "
          f"of {gi.numel()} indices equal; worst metric {max(rel, key=rel.get)} "
          f"{max(rel.values()):.3e} relative; parameters max diff {worst:.3e} (2 lr = "
          f"{2 * lr:.3e}), fewest within lr / 10 {p_worst} {100 * near[p_worst]:.3f}%; running "
          f"statistics max diff {stats:.3e}")
    print(f"(o) gradients against the float64 step, as a share of each leaf's largest entry, "
          f"{len(live)} of {len(ref)} leaves above rounding: card worst "
          f"{max(e[0] for e in err.values()):.3e}, CPU worst {max(e[1] for e in err.values()):.3e}"
          f"; the float64 step's indices {100 * same64:.3f}% equal to the card's")
    for k in sorted(err, key=lambda k: -err[k][0])[:5]:
        print(f"(o)   {k}: card {err[k][0]:.3e}, CPU {err[k][1]:.3e}")
    if same < 0.999 or max(rel.values()) > 1e-3 or off or worst > 2 * lr + 1e-6 \
            or near[p_worst] < 0.99 or stats > 1e-4:
        raise AssertionError(f"(o) the card's step departs from the CPU's; gradients off: {off}")


def wide_prior_routes() -> None:
    """(o) a transformer prior on a 2048-code VQVAE (K = 2049, width 64, 8
    steps, 16 samples) over 256 positions fits the JAX kernel's budget
    (fits_vmem), so it samples through the posterior kernels on their rows
    read from device memory: under fused_posterior on B6 alone and under
    prng B7 alone is launched, indices in [0, 2047], and 'on' gives at least
    99% of the plain route's indices on the same generator. Over 1024
    positions (a 32x32 grid) it is past fits_vmem and takes plain ops with
    no launch, as the JAX sampler takes XLA ops there."""
    from vq_vae_gan_diffusion_torch.models.transformer_vq_diffusion import (
        TransformerVQDiffusion)
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import fits_kernel_route

    for n in (N, 1024):
        tvq = TransformerVQDiffusion(codebook_size=WIDE_K - 1, seq_len=n, diffusion_steps=8,
                                     embedding_dim=64, num_layers=2, num_heads=4)
        tvq.predictor.init_weights(torch.Generator().manual_seed(13))
        tvq = tvq.cuda().eval()
        fits = fits_kernel_route(n, WIDE_K)
        g = int(n ** 0.5)
        for method in ("sample", "fast_sample"):
            plain = None
            for mode, kernel in ((False, None), (True, "discrete_posterior"),
                                 ("prng", "discrete_posterior_prng")):
                tvq.diffusion.fused_posterior = mode
                reset_counts()
                idx = getattr(tvq, method)(B, generator=torch.Generator(device="cuda")
                                           .manual_seed(14))
                torch.cuda.synchronize()
                launches = read_counts()
                used = {name: v for name, v in launches.items() if v}
                if list(used) != ([kernel] if fits and kernel else []) or \
                        tuple(idx.shape) != (B, g, g) or int(idx.min()) < 0 or \
                        int(idx.max()) > WIDE_K - 2:
                    raise AssertionError(f"(o) K = {WIDE_K} over {n} positions, {method} under "
                                         f"{mode}: launches {launches}, indices "
                                         f"{tuple(idx.shape)} in [{int(idx.min())}, "
                                         f"{int(idx.max())}]")
                agree = ""
                if mode is False:
                    plain = idx
                elif mode is True:
                    same = (idx == plain).double().mean().item()
                    agree = f", {100 * same:.2f}% of indices equal to plain ops'"
                    if same < 0.99:
                        raise AssertionError(f"(o) K = {WIDE_K} {method}: kernel and plain "
                                             f"routes agree on only {100 * same:.2f}%")
                print(f"(o) K = {WIDE_K} prior over {n} positions "
                      f"({'fits' if fits else 'past'} fits_vmem), {method}, fused_posterior "
                      f"{mode}: launches {used or 0}, indices in [{int(idx.min())}, "
                      f"{int(idx.max())}]{agree}")
        del tvq


def phase_train(card: str) -> dict:
    """(o): stage-1 training at full width; returns the step's numbers."""
    import tempfile

    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.data import load_dataloader
    from vq_vae_gan_diffusion_torch.train.vqgan_worker import VQGANVQVAEWorker

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_train_")
    cli_numbers = train_cli_run(log_dir)
    cfg = load_config(TRAIN_CONFIG).replace_path("trainer.log_dir", log_dir)
    loader, _ = load_dataloader(None, "train", None, cfg, seed=0)
    batch = next(iter(loader))
    if batch.shape != (TRAIN_B, 28, 28, 1):
        raise AssertionError(f"(o) batch {batch.shape}")
    worker = VQGANVQVAEWorker(cfg, log_dir, device="cuda")
    worker.state = worker.init_state()
    numbers = train_step_times(worker, torch.from_numpy(batch).cuda(), card)
    numbers["layer_ms"] = train_layer_times(worker, torch.from_numpy(batch).cuda(), card)
    numbers["cli_warm_images_per_s"] = cli_numbers["warm_images_per_s"]
    numbers["cli_epochs"] = [{k: e[k] for k in ("steps", "epoch_time_s", "loader_s",
                                                "artifact_s", "step_s")}
                             for e in cli_numbers["epochs"]]
    del worker
    torch.cuda.empty_cache()
    card_against_cpu(cfg, log_dir, batch, card)
    wide_prior_routes()
    return numbers


def main() -> int:
    card = phase_device()
    phase_build()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    timing = phase_kernel(card)
    launches = phase_main()
    phase_routes()
    units = phase_units(card)
    phase_other_shapes()
    vqd_launches = phase_vqdiffusion()
    phase_vqd_routes()
    posterior = phase_posterior(card)
    vqo_launches = phase_vqofficial(card)
    tvq_launches = phase_transformer(card)
    quant = phase_quant_kernels(card)
    quant_launches = phase_int8kv_path()
    phase_int8kv_routes()
    print(json.dumps({"vqgan_train_step": phase_train(card)}))
    f32 = timing[torch.float32]
    kernels = [{
        "name": "gpt_decode_stack", "route": "cuda",
        "source": "vq_vae_gan_diffusion_torch/csrc/gpt_decode.cu",
        "replaces": "vq_vae_gan_diffusion_tpu/ops/gpt_decode_pallas.py:181",
        "launches": launches, "max_abs_err": f32["max_abs_err"], "ms": f32["ms"],
        "plain_ms": f32["plain_ms"], "bound_ms": f32["bound_ms"], "bound_by": f32["bound_by"],
        "library_ms": None,
    }]
    # B2b's numbers at int8 and B2c's at int8kv, f32 compute; B2b's launches
    # from the int8 sample_tokens run, B2c's from the int8kv CLI run
    for name, mode, replaces, launches in (
            ("gpt_decode_stack_q", "int8", "vq_vae_gan_diffusion_tpu/ops/gpt_decode_pallas.py:449",
             quant_launches["int8"]["gpt_decode_stack_q"]),
            ("gpt_decode_stack_qkv", "int8kv",
             "vq_vae_gan_diffusion_tpu/ops/gpt_decode_pallas.py:460",
             quant_launches["int8kv"]["gpt_decode_stack_qkv"])):
        kernels.append(dict({"name": name, "route": "cuda",
                             "source": "vq_vae_gan_diffusion_torch/csrc/gpt_decode.cu",
                             "replaces": replaces, "launches": launches, "library_ms": None},
                            **quant[(mode, torch.float32)]))
    # the bottleneck kernel also stands for fused_bottleneck (:142), the same
    # function on unpacked NHWC
    for name, kind, replaces in (
            ("shuffle_bottleneck", "K1", "vq_vae_gan_diffusion_tpu/ops/shuffle_pallas.py:437"),
            ("shuffle_downsample", "K2", "vq_vae_gan_diffusion_tpu/ops/shuffle_pallas.py:630")):
        u = units[torch.float32][kind]
        kernels.append({
            "name": name, "route": "cuda",
            "source": "vq_vae_gan_diffusion_torch/csrc/shuffle_units.cu", "replaces": replaces,
            "launches": vqd_launches[name], "max_abs_err": u["max_abs_err"], "ms": u["ms"],
            "plain_ms": u["plain_ms"], "bound_ms": u["bound_ms"], "bound_by": u["bound_by"],
            "library_ms": None,
        })
    # max_abs_err of an index kernel: the largest gap between the plain
    # version's best score and its score at the kernel's pick
    for name, replaces, launches in (
            ("discrete_posterior", "vq_vae_gan_diffusion_tpu/ops/discrete_posterior_pallas.py:220",
             vqo_launches["discrete_posterior"]),
            ("discrete_posterior_prng",
             "vq_vae_gan_diffusion_tpu/ops/discrete_posterior_pallas.py:255",
             tvq_launches["sample, prng (B7)"]["discrete_posterior_prng"])):
        kernels.append(dict({"name": name, "route": "cuda",
                             "source": "vq_vae_gan_diffusion_torch/csrc/discrete_posterior.cu",
                             "replaces": replaces, "launches": launches, "library_ms": None},
                            **posterior[name]))
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on its path")
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

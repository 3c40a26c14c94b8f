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
      --debug`` writes metrics.jsonl and a checkpoint, then two epochs at
      batch 200, each split into the host's time in the loader, in the
      artifacts and the steps, give the loop's images/s (the first epoch
      with its setup, the second warm); ``train_step`` at
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
      cuBLAS's;
  (p) stage-2 GPT prior training on configs/training_config_gpt.yml at full
      width (C 1024, 12 layers of 16 heads, 256 tokens over the frozen
      VQVAE of training_config_small.yml, 256x256x3 synthetic images, f32,
      seeded weights): the decode stack against its plain version at batch
      4, the batch the training grid samples at, teacher-forced over the 129
      given positions and then free-running (1e-4 of max(1, max |plain|));
      ``python -m vq_vae_gan_diffusion_torch.train --debug`` (metrics.jsonl,
      a checkpoint, the four-row grid and the epoch's samples, 768
      decode-stack launches), then one ``log_artifacts`` call at batch 4 with
      exactly 512 launches (two samples of 256 positions); a warm
      ``train_step`` at batch 20: ms a step, images/s and tokens/s, peak
      memory, the profiler's busy share and top kernels, the step's
      operations and its bound at the f32 peak, as the ``{"gpt_train_step":
      ...}`` JSON line with two CLI epochs' images/s; one step at batch 2 on
      the card against the CPU and a float64 step, (o)'s rule;
  (q) stage-2 gaussian3d prior training on
      configs/training_config_vqdiffusion.yml at full width (U-Net base 64,
      mults (1, 2, 4, 8) on [B, 256, 96, 1], 1000 steps, indices recon on,
      batch 20): the train CLI in --debug on the config with its diffusion
      cut to 20 steps (metrics, a checkpoint, the recon grid, and the EMA
      copy's samples through the config's DDPM sampler, 20 steps where (g)
      serves 1000: 780 K1 and 80 K2 launches); the trained EMA
      U-Net through the kernel route against its module (h's 1e-3); a warm
      ``train_step`` at batch 20, as ``{"vqd_train_step": ...}`` with two
      CLI epochs (their samples as the hook's); one step at batch 2 on the
      card against the
      CPU and float64: gradients, running statistics and the EMA's leaves;
  (r) the pixel-space gaussiandiffusion3d worker on
      configs/training_config_pixel3d.yml at full width (U-Net base 64,
      mults (2, 4) on 28x28x1, 1000 steps): K1 and K2 against their plain
      versions at every unit shape of its forward (28x28 down to 7x7 at
      batch 36, the samples' batch), as (f); the train CLI in --debug
      (metrics, a checkpoint, the EMA's 36 samples with 21000 K1 and 2000
      K2 launches: 21 and 2 a forward, counted from the U-Net's units);
      the EMA's samples again, counted and timed; the trained EMA U-Net
      through the kernel route against its module; a warm ``train_step``
      at batch 500 as ``{"pixel3d_train_step": ...}``; one step at batch 4
      on the card against the CPU and float64, (q)'s rule;
  (s) VQ_Official prior training on configs/training_config_vqofficial.yml
      at full width (K = 1024 over 256 tokens, the U-Net on [B, 1024, 256,
      1], the frozen VQVAE of training_config_small.yml): the train CLI in
      --debug with the hook's chain cut to 20 steps (19 B6, 780 K1, 80 K2
      launches, as (j)) and the importance-sampling history's counts; the
      peak memory of a warm step at batch 2 and 4, which must leave the
      config's batch under 70 GiB; a warm ``train_step`` at the config's
      batch as ``{"vqofficial_train_step": ...}``; one step at batch 1 on the
      card against the CPU (indices, metrics, the new LtState, parameters);
  (t) B6 and B7 against their plain versions at the demo's logits [4, 64,
      64] (K = 65); the demo ``vq_vae_gan_diffusion_torch.vq_diffusion`` on
      the card under --fused-posterior on and prng: 23 B6 or 23 B7 launches
      (sample 19, fast_sample 4), indices in the codebook; its trained
      prior's sample with the same noise, posterior kernel against plain
      ops (at least 99% of indices equal);
  (u) the gaussiandiffusion2d VQ-diffusion prior on
      configs/inference_config_gaussian2d.yml at full width (the Conv1d
      U-Net, base 64, mults (1, 2, 4, 8), on the [16, 256, 96] lookup-table
      state: 256 channels over length 96; the config's 1000 DDIM steps cut
      to 50; seeded weights):
      ``generate`` cold then warm (s a chain, ms a step, peak memory; no
      hand-written kernel runs on this path: its convolutions are cuDNN's,
      its products cuBLAS's); one sample's 50-step chain on the card and
      on the CPU from the same indices and noise (at least 99% of indices
      equal); the train CLI in --debug on
      configs/training_config_gaussian2d.yml; a warm ``train_step`` at
      batch 20 @ 256x256x3 as the ``{"gaussian2d_train_step": ...}`` JSON
      line; one step at batch 2 on the card against the CPU and float64,
      (q)'s rule;
  (v) the VQ_Official prior on its Conv1d U-Net (unet_dim 2) on
      configs/inference_config_vqofficial1d.yml at full width (K = 1024
      channels over 256 positions, K - 1 out), the chain cut to 20 steps as
      in (j): ``generate`` cold and warm with 19 B6 launches and nothing
      else, then under --fused-posterior prng with 19 B7; B6 and B7 against
      their plain versions at this U-Net's logits [16, 256, 1023] (t in {0,
      1, T/2, T-1}, masked positions), with B6's time beside its plain
      version's; the kernel route against plain ops over a 20-step chain
      with the same noise (every index equal); the train CLI in --debug on
      configs/training_config_vqofficial1d.yml with the hook cut to 20
      steps (19 B6), and a warm ``train_step`` at batch 20 as
      ``{"vqofficial1d_train_step": ...}`` with the hook's launches;
  (w) the pixel gaussiandiffusion2d worker on
      configs/training_config_pixel2d.yml (28x28x1 images, rows as the
      Conv1d U-Net's 28 channels, mults (1, 2, 4)): the train CLI in
      --debug (metrics, a checkpoint, the EMA's 4 samples), the 4 samples'
      DDIM chain, cut from 1000 steps to 50, timed, a warm ``train_step``
      at batch 500 as ``{"pixel2d_train_step": ...}``;
  (x) ``c_vqdiffusion`` and ``v_vqdiffusion`` on
      configs/training_config_{cvq,vvq}.yml (batch 20 @ 256x256x3, the
      Conv1d U-Net over 8 or 256 channels and 256 positions): a warm
      ``train_step`` each and the EMA's 16 samples through the DDIM chain,
      cut from 500 steps to 50, decoded, as ``{"continuous_vq_train_step":
      ...}``;
  (y) the VAE on configs/training_config_large.yml (256x256x3, a 16x16x256
      latent, the config's latent_size 32): the train CLI in --debug (the
      reconstruction GIF, the samples and val grids, a checkpoint);
      ``generate`` cold and warm (16 samples drawn at 32x32 decoding to
      512x512, 16 val reconstructions); a warm ``train_step`` at batch 20
      as ``{"vae_train_step": ...}``; one step at batch 2 on the card
      against the CPU and float64 with the same ε, (q)'s rule;
  (z) the pixel DDPM, ``python -m vq_vae_gan_diffusion_torch.train_diffusion``
      (the Conv2d U-Net at dim 64, mults (1, 2, 4, 8)): the CLI in --debug
      (11 steps, a checkpoint, 4 samples through 8 DDIM steps); a warm
      ``train_step`` at batch 500 of 32x32x3 with dropout 0.1 as
      ``{"pixel_ddpm_train_step": ...}``; the EMA's 64 samples through 50
      DDIM steps (the root CLI's 500, cut to fit the script's time); one
      step at batch 4 with dropout off on the card against the CPU and
      float64, (q)'s rule;
  (aa) ``--bf16`` on the card: the bf16 kernel calls at the training hooks'
      shapes against their plain versions at (c)'s and (f)'s bf16
      tolerances (the decode stack at batch 4 over 256 positions, K1/K2 at
      the gaussian3d and VQ_Official U-Nets' unit shapes, B6 on [16, 256,
      1023] bf16 logits); the train CLI in --debug --bf16 on (o), (p), (q),
      (s) (hook cut to 20 steps) and (v), with the f32 phases' launches and
      the launches of each kernel's bf16 instantiation (768 B1; 780 K1 and
      80 K2 at (q)'s 20-step hook; 780 K1 and 80 K2 with 19 B6 on f32
      logits at (s)'s, as the JAX hook casts the folded forward back to its
      input's dtype; 19 B6 on the
      Conv1d U-Net's bf16 logits), every state and checkpoint tensor f32;
      train_diffusion --debug --bf16 likewise; a warm bf16 step beside the
      f32 one at each f32 phase's batch as ``{"<phase>_train_step_bf16":
      ...}``; one bf16 stage-1 step card against CPU by the bf16 rule;
  (ab) the cross-attention prior at (k)'s width on a random cond_emb [16,
      77, 512] (99 B6 ``sample``, 24 ``fast_sample``, 99 B7 under prng;
      kernel route and plain ops index for index under injected noise; a
      training loss card against CPU within 1e-5); feature_fid card against
      CPU within 1e-3 on 32 images at 64^2 and timed on 256 at 256^2;
      --profile's trace with CUDA kernel events; SIGTERM to a train CLI
      subprocess (exit 143, a checkpoint that resumes); the loop at
      steps_per_dispatch 1 and 4;
  (ac) the native sample-store loader (``dataset.use_native_loader``): its
      library built from csrc/sampledb.cpp with the host compiler at first
      use; ``SampleStore.gather`` against the port's ``Preprocessor`` within
      1e-6 on (o)'s synthetic 28² x 1 store and on a 256² x 3 one; two
      seeded epochs, augmented and not, run twice, bit for bit equal; the
      stage-1 train CLI on a copy of (o)'s config with the key set, batch
      200, two epochs, through the native route (the run's log and its two
      stores; there is no fallback), as the ``{"native_loader_cli": ...}``
      JSON line beside (o)'s epochs on the Python loader;
  (ad) the reference's checkpoint files at full width, drawn from fixed
      seeds: training_config_small.yml's VQVAE and discriminator, the GPT
      of inference_config_small.yml, VQ_Official's ``{"diffusion", ...,
      "model_ema"}`` (training_config_vqofficial.yml, the EMA drawn apart)
      and gaussiandiffusion3d's ``{"model", "model_ema"}``
      (training_config_pixel3d.yml), each through ``import_checkpoint`` on
      the card and resumed through its ``resume_path`` with every tensor
      equal to its source (the LtState to the Lt buffers); then VQ_Official
      served from its imported file by ``generate --ckpt``: a 20-step chain
      with exactly 780 K1, 80 K2 and 19 B6 launches, every index equal to
      the in-memory EMA U-Net's chain with the same generator.

``--only r,s`` (any of o-z, aa-ad) runs (a), (b) and those phases alone,
and prints no kernels line and no result line.

Each path, (d), (g), (j), (m), each run of (k), the training hooks of
(p)-(s), each run of (t), each run of (u)-(z) and (ad)'s generate run, runs with every kernel's
launch count set to 0 just before it and read just after. Before the last line it prints one JSON line
describing every kernel of the paths, and the card's name and power limit;
the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import re
import shutil
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
TRAIN_EPOCHS = 2
# stage-2 training at full width: the GPT prior and the gaussian3d prior of
# training_config_small.yml on synthetic data, batch 20 @ 256x256x3; the
# GPT's training grid samples LOG_B images, half given (PREFIX positions
# with SOS)
GPT_TRAIN_CONFIG = "configs/training_config_gpt.yml"
VQD_TRAIN_CONFIG = "configs/training_config_vqdiffusion.yml"
STAGE2_B, STAGE2_STEPS, LOG_B, PREFIX = 20, 5, 4, N // 2 + 1
STAGE2_EPOCHS = 2
# the gaussian3d prior's training runs of the CLI in (q) and (aa): the
# config's DDPM sampler over a diffusion cut from 1000 steps (which (g)
# serves) to 20, to fit the script's time; the U-Net's time table has as
# many rows
G3D_HOOK_STEPS = 20
G3D_HOOK = {"architecture.vqdiffusion.diffusion_steps": G3D_HOOK_STEPS,
            "architecture.vqdiffusion.sampling_steps": G3D_HOOK_STEPS}
# the pixel-space gaussiandiffusion3d worker on training_config_pixel3d.yml:
# batch 500 of 28x28x1, the U-Net at base 64 with mults (2, 4), 36 samples
PIXEL_CONFIG, PIXEL_B, PIXEL_HW, PIXEL_MULTS, PIXEL_SAMPLES = (
    "configs/training_config_pixel3d.yml", 500, 28, (2, 4), 36)
# the VQ_Official prior's training on training_config_vqofficial.yml
VQO_TRAIN_CONFIG = "configs/training_config_vqofficial.yml"
# the Conv1d U-Net family at the full widths of training_config_small.yml:
# the gaussian2d prior, the VQ_Official prior on its Conv1d U-Net, the pixel
# gaussiandiffusion2d worker (4 samples, as the JAX worker draws), the
# continuous priors (500 DDIM steps)
G2D_CONFIG, G2D_TRAIN_CONFIG = ("configs/inference_config_gaussian2d.yml",
                                "configs/training_config_gaussian2d.yml")
VQO1D_CONFIG, VQO1D_TRAIN_CONFIG = ("configs/inference_config_vqofficial1d.yml",
                                    "configs/training_config_vqofficial1d.yml")
PIXEL2D_CONFIG, PIXEL2D_SAMPLES = "configs/training_config_pixel2d.yml", 4
# the gaussian2d prior's and the pixel gaussiandiffusion2d worker's chains in
# (u) and (w), cut from the configs' 1000 DDIM steps to fit the script's time
G2D_STEPS = 50
CONTINUOUS_CONFIGS = {"c_vqdiffusion": "configs/training_config_cvq.yml",
                      "v_vqdiffusion": "configs/training_config_vvq.yml"}
CONTINUOUS_STEPS = 50           # the configs' 500 DDIM steps, cut to fit the script's time
# the VAE family on training_config_large.yml: batch 20 of 256x256x3 (a 16x16
# latent), 16 samples drawn at the config's latent_size 32, decoding to 512x512
VAE_CONFIG, VAE_B, VAE_LATENT, VAE_SAMPLE_HW = "configs/training_config_large.yml", 20, 16, 512
# the pixel DDPM of the root train_diffusion.py at its defaults: batch 500 of
# 32x32x3 (cifar10, synthetic where it is not on disk), the U-Net at dim 64
# with mults (1, 2, 4, 8) and dropout 0.1; the EMA's 64 samples through 50
# DDIM steps (the root CLI's 500, cut to fit the script's time)
DDPM_B, DDPM_HW, DDPM_SAMPLES, DDPM_DDIM = 500, 32, 64, 50
# (o)'s CLI epochs on the Python loader, beside which (ac) runs the native one
PYTHON_LOADER_RUN: dict = {}
# (ac): the native loader's augmentation recipe (transforms.random_flips_and_rotation's)
NATIVE_AUGMENT = dict(p_hflip=0.2, p_vflip=0.2, p_rot=0.3, max_deg=25.0)
# (ad): the reference's files drawn at full width from these configs, by family
REF_CONFIGS = {"vqgan": "configs/training_config_small.yml",
               "vqvae_transformer": "configs/inference_config_small.yml",
               "vqdiffusion": "configs/training_config_vqofficial.yml",
               "gaussiandiffusion3d": "configs/training_config_pixel3d.yml"}


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
        if hasattr(fn, "bf16_launches"):
            fn.bf16_launches = 0


def read_bf16_counts() -> dict:
    """The launches of each kernel's bf16 instantiation since the last
    :func:`reset_counts`, where any."""
    return {name: fn.bf16_launches for name, fn in kernel_wrappers().items()
            if getattr(fn, "bf16_launches", 0)}


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
                kernel_reps: int = 20, plain_reps: int = 3, mults: tuple = (1, 2, 4, 8),
                batch: int = B, dtypes: tuple = (torch.float32, torch.bfloat16)) -> dict:
    """The bottleneck and downsample kernels against reference_bottleneck /
    reference_downsample at every distinct unit shape of the U-Net forward
    (base 64, ``mults``) on a [batch, h, w, C] input (the gaussian3d state
    by default).

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
    per call over one forward's bottleneck and downsample calls (39 and 4
    at mults (1, 2, 4, 8): each level 4 bottlenecks and a downsample down,
    5 bottlenecks up, and 3 in the middle).
    """
    from vq_vae_gan_diffusion_torch.ops.shuffle import (bottleneck_plan, downsample_plan,
                                                        fused_bottleneck, fused_downsample,
                                                        reference_bottleneck,
                                                        reference_downsample)
    units = unet_unit_shapes(h, w, 64, mults)
    counts: dict = {}
    for u in units:
        counts[u] = counts.get(u, 0) + 1
    if [k for k, *_ in units].count("K1") != 9 * len(mults) + 3 or \
            len(units) != 10 * len(mults) + 3:
        raise AssertionError(f"unexpected unit list {units}")
    gen = torch.Generator(device="cuda").manual_seed(3)
    result = {}
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
        if dtype not in dtypes:
            continue
        tag = "f32" if dtype == torch.float32 else "bf16"
        acc = {k: {"max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0, "bytes_ms": 0.0,
                   "ops_ms": 0.0, "bound_ms": 0.0, "calls": 0} for k in ("K1", "K2")}
        for (kind, uh, uw, c_in, c_out), count in counts.items():
            p = random_unit(kind, c_in, c_out, dtype, gen)
            x = torch.randn(batch, uh, uw, c_in, generator=gen, device="cuda").to(dtype)
            kernel, plain = ((fused_bottleneck, reference_bottleneck) if kind == "K1"
                             else (fused_downsample, reference_downsample))
            what = f"{tag} {kind} {uh}x{uw} {c_in}->{c_out}"
            got, want = kernel(x, p), plain(x, p)
            torch.cuda.synchronize()
            err = check_close(what, got, want, tol)
            if kind == "K2":
                t_vec = torch.randn(batch, c_in, generator=gen, device="cuda").to(dtype)
                got_t, want_t = kernel(x, p, t_vec), plain(x, p, t_vec)
                torch.cuda.synchronize()
                err_t = check_close(what + " t_vec", got_t, want_t, tol)
                print(f"({label}) {what} with the silu(x + t_vec) prologue: "
                      f"max abs err {err_t:.3e}")
                err = max(err, err_t)
            ms = cuda_ms(lambda: kernel(x, p), reps=kernel_reps)
            plain_ms = cuda_ms(lambda: plain(x, p), reps=plain_reps)
            by_bytes, by_ops = shuffle_unit_bound(kind, uh, uw, c_in, c_out, batch, dtype, card)
            bound = max(by_bytes, by_ops)
            plan = (bottleneck_plan(batch, uh, uw, c_in // 2, c_out // 2) if kind == "K1"
                    else downsample_plan(batch, uh, uw, c_in, c_out // 2))
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
    return cli_epochs("o", TRAIN_CONFIG, log_dir, TRAIN_EPOCHS, TRAIN_B)


def cli_epochs(label: str, config: str, log_dir: str, epochs: int, batch: int,
               loader: str = "synthetic images decoded on the host as it goes",
               overrides: dict | None = None) -> dict:
    """The train CLI for ``epochs`` epochs on ``config`` (with
    ``overrides``), each epoch's time split as the loop records it (the
    host's time in the loader, in the artifacts, and the steps with the
    device's tail). Returns the epochs' rows, the images/s of the epochs
    after the first and the run dir."""
    import os

    from vq_vae_gan_diffusion_torch.train import cli

    out = cli.run(["--config", config, "--epochs", str(epochs)],
                  overrides={"trainer.log_dir": log_dir, **(overrides or {})})
    with open(os.path.join(out["run_dir"], "metrics.jsonl")) as f:
        rows = [r for r in map(json.loads, f) if "epoch_time_s" in r]
    if len(rows) != epochs:
        raise AssertionError(f"({label}) {len(rows)} epoch rows in metrics.jsonl")
    for i, e in enumerate(rows):
        print(f"({label}) train CLI epoch {i} ({'setup included' if i == 0 else 'warm'}): "
              f"{e['steps']} steps at batch {batch} of {loader}, "
              f"{e['epoch_time_s']:.3f} s, {e['images_per_sec']:.2f} images/s; "
              f"host in the loader {e['loader_s']:.3f} s, in the artifacts "
              f"{e['artifact_s']:.3f} s, steps and the device's tail {e['step_s']:.3f} s")
    warm = rows[1:]
    rate = sum(e["steps"] for e in warm) * batch / sum(e["epoch_time_s"] for e in warm)
    print(f"({label}) train CLI, epochs 1-{epochs - 1}: {rate:.2f} images/s")
    return {"epochs": rows, "warm_images_per_s": rate, "run_dir": out["run_dir"]}


def cli_numbers(run: dict) -> dict:
    """The JSON line's share of :func:`cli_epochs`' result."""
    return {"cli_warm_images_per_s": run["warm_images_per_s"],
            "cli_epochs": [{k: e[k] for k in ("steps", "epoch_time_s", "loader_s", "artifact_s",
                                              "step_s")} for e in run["epochs"]]}


def profile_steps(step, n: int = 3) -> tuple:
    """torch.profiler over ``n`` calls of ``step``: the device ms a call
    (CUDA-side events less the ranges the optimizer annotates, which overlap
    its kernels), the device's busy share of the window's wall time, the
    window's ms a call, and the kernel events, largest first."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        window_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type.name == "CUDA"
               and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    return (dev_ms / n, dev_ms / window_ms, window_ms / n,
            sorted(kernels, key=lambda e: -e.self_device_time_total))


def print_kernels(label: str, kernels: list, top: int, n: int = 3) -> None:
    """The ``top`` kernels of a profiled window of ``n`` steps, ms and
    launches a step."""
    for e in kernels[:top]:
        print(f"({label})   {e.self_device_time_total / n / 1e3:9.3f} ms a step "
              f"{e.count / n:6.1f} launches  {e.key[:90]}")


def train_step_times(worker, batch: torch.Tensor, card: str) -> dict:
    """(o) warm ms a train_step at full width before and after disc_start,
    peak device memory, and a torch.profiler window of three steps."""
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
    dev_ms, busy, window_ms, kernels = profile_steps(lambda: steps(1))
    with FlopCounterMode(display=False) as flops:
        steps(1)
    bound_ms = 1e3 * flops.get_total_flops() / F32_PEAK_FLOPS
    print(f"(o) train_step [{TRAIN_B}, 28, 28, 1] f32 warm: {ms_before:.3f} ms before disc_start, "
          f"{ms_after:.3f} ms after ({1e3 * TRAIN_B / ms_after:.1f} images/s), peak "
          f"{peak:.3f} GiB; profiled 3 steps: device {dev_ms:.3f} ms a step, busy "
          f"{100 * busy:.1f}% of {window_ms:.3f} ms; "
          f"{flops.get_total_flops() / 1e12:.4f} TFLOP a step, bound {bound_ms:.3f} ms at the "
          f"f32 peak; {card}")
    print(f"(o) metrics after disc_start: {m_after}")
    print_kernels("o", kernels, 15)
    return {"config": TRAIN_CONFIG, "batch": TRAIN_B, "dtype": "float32",
            "ms_before_disc_start": ms_before, "ms_after_disc_start": ms_after,
            "images_per_s": 1e3 * TRAIN_B / ms_after, "peak_gib": peak,
            "device_ms_per_step": dev_ms, "device_busy_share": busy,
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


def gradients_against_float64(label: str, card: dict, cpus: list, ref: dict) -> set:
    """Each leaf's gradient on the card and on the CPU in f32 against the
    float64 step's (``ref``), as a share of the leaf's largest entry. A
    leaf whose reference gradient is below 1e-5 of the step's largest is
    rounding; each other (live) leaf of the card must lie no further from
    the reference than the larger of twice the CPU's distance and 1e-4.
    ``cpus`` holds the CPU's f32 gradients of one or more runs that differ
    only in their reduction order (the intra-op thread count); the CPU's
    distance is the largest of theirs. Returns the live leaves."""
    top = max(float(g.abs().max()) for g in ref.values())
    live = {k for k, g in ref.items() if float(g.abs().max()) > 1e-5 * top}

    def dist(grads: dict, k: str) -> float:
        return float((grads[k] - ref[k]).abs().max()) / float(ref[k].abs().max())
    err = {k: (dist(card, k), *[dist(cpu, k) for cpu in cpus]) for k in live}
    off = {k: e for k, e in err.items() if e[0] > max(2 * max(e[1:]), 1e-4)}
    worst = [max(e[i] for e in err.values()) for i in range(len(cpus) + 1)]
    print(f"({label}) gradients against the float64 step, as a share of each leaf's largest "
          f"entry, {len(live)} of {len(ref)} leaves above rounding: card worst {worst[0]:.3e}, "
          f"CPU worst {', '.join(f'{w:.3e}' for w in worst[1:])}")
    if len(cpus) > 1:
        ratio = sorted(e[2] / max(e[1], 1e-30) for e in err.values())
        print(f"({label}) the CPU's second reduction order against its first, leaf by leaf: "
              f"median {ratio[len(ratio) // 2]:.2f}x, from {ratio[0]:.2f}x to {ratio[-1]:.2f}x")
    for k in sorted(err, key=lambda k: -err[k][0] / max(err[k][1:]))[:5]:
        print(f"({label})   {k}: card {err[k][0]:.3e}, CPU "
              f"{', '.join(f'{e:.3e}' for e in err[k][1:])}")
    if off:
        raise AssertionError(f"({label}) the card's gradients depart from float64's: {off}")
    return live


def params_card_against_cpu(card: dict, cpu: dict, live: set, lr: float) -> tuple:
    """Parameters after one step on the card against the CPU's: the largest
    difference, the live leaf with the fewest entries within lr / 10 and
    each live leaf's share within it, and the largest difference of the
    running statistics (0 where there are none)."""
    diffs = {k: (card[k].double() - cpu[k].double()).abs() for k in cpu
             if "num_batches" not in k}
    stats = max([float(d.max()) for k, d in diffs.items() if "running" in k], default=0.0)
    worst = max(float(d.max()) for k, d in diffs.items() if "running" not in k)
    near = {k: (diffs[k] <= lr / 10).double().mean().item() for k in live}
    return worst, min(near, key=near.get), near, stats


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
    same = (gi == ci).double().mean().item()
    same64 = (gi == runs["cpu", torch.float64][0]).double().mean().item()
    rel = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-6) for k in cm}
    lr = float(cfg.trainer.vqvae.learning_rate)
    live = gradients_against_float64("o", gg, [cg], runs["cpu", torch.float64][3])
    worst, p_worst, near, stats = params_card_against_cpu(gp, cp, live, lr)
    print(f"(o) one step on the card against the CPU ({csec:.1f} s on the CPU): {100 * same:.3f}% "
          f"of {gi.numel()} indices equal (the float64 step's {100 * same64:.3f}% equal to the "
          f"card's); worst metric {max(rel, key=rel.get)} {max(rel.values()):.3e} relative; "
          f"parameters max diff {worst:.3e} (2 lr = {2 * lr:.3e}), fewest within lr / 10 "
          f"{p_worst} {100 * near[p_worst]:.3f}%; running statistics max diff {stats:.3e}")
    if same < 0.999 or max(rel.values()) > 1e-3 or worst > 2 * lr + 1e-6 \
            or near[p_worst] < 0.99 or stats > 1e-4:
        raise AssertionError("(o) the card's step departs from the CPU's")


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
    cli_run = train_cli_run(log_dir)
    PYTHON_LOADER_RUN.update(cli_run)
    cfg = load_config(TRAIN_CONFIG).replace_path("trainer.log_dir", log_dir)
    loader, _ = load_dataloader(None, "train", None, cfg, seed=0)
    batch = next(iter(loader))
    if batch.shape != (TRAIN_B, 28, 28, 1):
        raise AssertionError(f"(o) batch {batch.shape}")
    worker = VQGANVQVAEWorker(cfg, log_dir, device="cuda")
    worker.state = worker.init_state()
    numbers = train_step_times(worker, torch.from_numpy(batch).cuda(), card)
    numbers["layer_ms"] = train_layer_times(worker, torch.from_numpy(batch).cuda(), card)
    numbers.update(cli_numbers(cli_run))
    del worker
    torch.cuda.empty_cache()
    card_against_cpu(cfg, log_dir, batch, card)
    wide_prior_routes()
    return numbers


def stage2_step_times(label: str, key: str, worker, batch: torch.Tensor, card: str,
                      tokens: int | None = None, profiled: int = 3) -> dict:
    """(p), (q): a stage-2 worker's warm ``train_step`` at full width, f32:
    ms a step over STAGE2_STEPS after two, images/s (and tokens/s), peak
    device memory, through torch.profiler over ``profiled`` steps the
    device's busy share and the top kernels, the step's operations
    (torch.utils.flop_counter) and its bound at the f32 peak."""
    from torch.utils.flop_counter import FlopCounterMode

    def step() -> dict:
        return worker.train_step(worker.state, batch, worker.generator)[1]

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(STAGE2_STEPS):
        metrics = step()
    torch.cuda.synchronize()
    ms = 1e3 * (time.perf_counter() - t0) / STAGE2_STEPS
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    metrics = {k: float(v) for k, v in metrics.items()}
    if not all(math.isfinite(v) for v in metrics.values()):
        raise AssertionError(f"({label}) metrics {metrics}")
    dev_ms, busy, window_ms, kernels = profile_steps(step, profiled)
    with FlopCounterMode(display=False) as flops:
        step()
    total = flops.get_total_flops()
    b = batch.shape[0]
    numbers = {"config": key, "batch": b, "dtype": "float32", "ms_per_step": ms,
               "images_per_s": 1e3 * b / ms, "peak_gib": peak, "device_ms_per_step": dev_ms,
               "device_busy_share": busy, "tflop_per_step": total / 1e12,
               "bound_ms": 1e3 * total / F32_PEAK_FLOPS, "card": card}
    rate = f"{numbers['images_per_s']:.2f} images/s"
    if tokens:
        numbers["tokens_per_s"] = 1e3 * b * tokens / ms
        rate += f", {numbers['tokens_per_s']:.0f} tokens/s"
    print(f"({label}) train_step {list(batch.shape)} f32 warm: {ms:.3f} ms a step ({rate}), peak "
          f"{peak:.3f} GiB; profiled {profiled} steps: device {dev_ms:.3f} ms a step, busy "
          f"{100 * busy:.1f}% of {window_ms:.3f} ms; {total / 1e12:.4f} TFLOP a step, bound "
          f"{numbers['bound_ms']:.3f} ms at the f32 peak; metrics {metrics}; {card}")
    print_kernels(label, kernels, 12, profiled)
    return numbers


def run_train_cli(label: str, config: str, log_dir: str, want_launches: dict,
                  files: tuple, overrides: dict | None = None, extra: tuple = ()) -> dict:
    """The train CLI in --debug on ``config`` (with ``overrides``) on the
    card, every kernel's launch count set to 0 just before it and read just
    after: two steps in metrics.jsonl, one checkpoint, ``files`` in the run
    dir, and the launches ``want_launches`` (every other kernel none).
    Returns the CLI's result."""
    import glob
    import os

    from vq_vae_gan_diffusion_torch.train import cli

    reset_counts()
    t0 = time.perf_counter()
    out = cli.run(["--config", config, "--debug", *extra],
                  overrides={"trainer.log_dir": log_dir, **(overrides or {})})
    sec = time.perf_counter() - t0
    launches = read_counts()
    want = {name: want_launches.get(name, 0) for name in launches}
    with open(os.path.join(out["run_dir"], "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    ckpts = glob.glob(os.path.join(out["run_dir"], "ckpt", "step_*.pth"))
    missing = [name for name in files if not os.path.exists(os.path.join(out["run_dir"], name))]
    if [r["step"] for r in rows[:2]] != [1, 2] or not all(
            math.isfinite(v) for r in rows for v in r.values()):
        raise AssertionError(f"({label}) metrics.jsonl rows {rows}")
    if len(ckpts) != 1 or missing or launches != want:
        raise AssertionError(f"({label}) checkpoints {ckpts}, missing {missing}, launches "
                             f"{launches}, expected {want}")
    print(f"({label}) train CLI --debug {' '.join(extra)} on {config}: {sec:.1f} s; launches "
          f"{ {k: v for k, v in launches.items() if v} }; metrics.jsonl step 2 {rows[1]}; "
          f"checkpoint {os.path.basename(ckpts[0])}; {', '.join(files)}")
    return out


def gpt_decode_batch4(card: str, dtype: torch.dtype = torch.float32, label: str = "p") -> float:
    """(p) the decode stack at the batch the GPT's training grid samples at
    (LOG_B = 4, full width, seeded weights): every position of a 256-token
    run, teacher-forced over the PREFIX given positions (SOS and half the
    indices) and then free-running on the kernel's own samples, against
    reference_decode_stack on the same cache, within (c)'s tolerance of
    max(1, max |plain|): 1e-4 in f32, 2e-2 in bf16 (the weights packed from
    the f32 ones, as the training hook packs them). Returns the kernel's ms
    a call over the run."""
    import torch.nn.functional as F

    from vq_vae_gan_diffusion_torch.models.mingpt import GPT, categorical, top_k_filter
    from vq_vae_gan_diffusion_torch.ops.gpt_decode import (fused_decode_stack,
                                                           pack_decode_params,
                                                           reference_decode_stack)
    gpt = GPT(vocab_size=1024, block_size=512, n_layer=L, n_head=H, n_embd=C)
    gpt.init_weights(torch.Generator().manual_seed(21))
    gpt = gpt.cuda().eval()
    packed = pack_decode_params(gpt, dtype, None)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    gen = torch.Generator(device="cuda").manual_seed(22)
    prefix = torch.randint(0, 1024, (LOG_B, PREFIX), generator=gen, device="cuda")
    kv = torch.zeros(L, LOG_B, N, 2 * C, device="cuda", dtype=dtype)
    worst = {"teacher-forced": 0.0, "free-running": 0.0}
    token = prefix[:, 0]
    with torch.no_grad():
        for t in range(N):
            phase = "teacher-forced" if t < PREFIX else "free-running"
            x = gpt.tok_emb.weight[prefix[:, t] if t < PREFIX else token] + gpt.pos_emb[0, t]
            h_k, kv_k = fused_decode_stack(x, packed, kv, t, n_head=H)
            h_r, kv_r = reference_decode_stack(x, packed, kv, t, n_head=H)
            for what, got, want in (("x_out", h_k, h_r), ("kv_new", kv_k, kv_r)):
                err = check_close(f"({label}) {dtype} batch {LOG_B} t={t} {what}", got, want, tol)
                worst[phase] = max(worst[phase], err / max(1.0, want.abs().max().item()))
            kv[:, :, t] = kv_k
            logits = F.layer_norm(h_k, (C,), gpt.ln_f.weight, gpt.ln_f.bias, eps=1e-5) \
                @ gpt.head.weight.T
            token = categorical(top_k_filter(logits, 100), gen)
    ms = cuda_ms(lambda: fused_decode_stack(x, packed, kv, N - 1, n_head=H), reps=20)
    print(f"({label}) {dtype} decode stack at batch {LOG_B}, {N} positions against plain: worst "
          f"err / scale {worst['teacher-forced']:.3e} teacher-forced over {PREFIX}, "
          f"{worst['free-running']:.3e} free-running after (tol {tol}); kernel {ms:.4f} ms a "
          f"call at t = {N - 1}; {card}")
    return ms


def gpt_card_against_cpu(cfg, log_dir: str, batch, card: str) -> None:
    """(p) one GPT step at batch 2 from the same seeded weights, batch and
    corruption draws on the card and on the CPU in f32, and on the CPU in
    float64 as the reference of both: at least 99.9% of the frozen VQVAE's
    indices equal, ce_loss within 1e-4 relative, token_accuracy within one
    token, gradients by (o)'s rule (:func:`gradients_against_float64`),
    every parameter within 2 lr of the CPU's and each live leaf 99% within
    lr / 10."""
    from vq_vae_gan_diffusion_torch.train.vq_transformer_worker import VQTransformerWorker

    b = batch.shape[0]
    gen = torch.Generator().manual_seed(23)
    keep = torch.bernoulli(torch.full((b, N), 0.5), generator=gen).long()
    rand = torch.randint(0, int(cfg.architecture.vqvae.num_codebook_vectors), (b, N),
                         generator=gen)
    runs = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64)):
        w = VQTransformerWorker(cfg, log_dir, device=device)
        state = w.init_state()
        w.composite.to(dtype)
        x = torch.from_numpy(batch).to(device, dtype)
        idx = w.composite.encode_to_z(x)[1].cpu()
        t0 = time.perf_counter()
        _, metrics = w.train_step(state, x, keep=keep.to(device), random_indices=rand.to(device))
        metrics = {k: float(v) for k, v in metrics.items()}
        sec = time.perf_counter() - t0
        runs[device, dtype] = (idx, metrics,
                               {k: v.cpu() for k, v in state.gpt.state_dict().items()},
                               {k: p.grad.cpu().double() for k, p in state.gpt.named_parameters()},
                               sec)
        del w, state
    (gi, gm, gp, gg, _), (ci, cm, cp, cg, csec) = runs["cuda", torch.float32], \
        runs["cpu", torch.float32]
    same = (gi == ci).double().mean().item()
    lr = float(cfg.trainer.vqvae_transformer.learning_rate)
    live = gradients_against_float64("p", gg, [cg], runs["cpu", torch.float64][3])
    worst, p_worst, near, _ = params_card_against_cpu(gp, cp, live, lr)
    loss_rel = abs(gm["ce_loss"] - cm["ce_loss"]) / cm["ce_loss"]
    acc_gap = abs(gm["token_accuracy"] - cm["token_accuracy"])
    print(f"(p) one step at batch {b} on the card against the CPU ({csec:.1f} s on the CPU): "
          f"{100 * same:.3f}% of {gi.numel()} indices equal; ce_loss {gm['ce_loss']:.6f} vs "
          f"{cm['ce_loss']:.6f} ({loss_rel:.3e} relative), token_accuracy "
          f"{gm['token_accuracy']:.6f} vs {cm['token_accuracy']:.6f}; parameters max diff "
          f"{worst:.3e} (2 lr = {2 * lr:.3e}), fewest within lr / 10 {p_worst} "
          f"{100 * near[p_worst]:.3f}%; {card}")
    if same < 0.999 or loss_rel > 1e-4 or acc_gap > 1.0 / (b * N) + 1e-9 \
            or worst > 2 * lr + 1e-6 or near[p_worst] < 0.99:
        raise AssertionError("(p) the card's GPT step departs from the CPU's")


def phase_gpt_train(card: str) -> dict:
    """(p): GPT prior training at full width; returns the step's numbers."""
    import os
    import tempfile

    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.data import load_dataloader
    from vq_vae_gan_diffusion_torch.train.vq_transformer_worker import VQTransformerWorker

    gpt_decode_batch4(card)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_gpt_")
    out = run_train_cli("p", GPT_TRAIN_CONFIG, log_dir, {"gpt_decode_stack": 3 * N},
                        ("transformer_epoch0_0.jpg", "samples_epoch0.jpg"))
    cfg = load_config(GPT_TRAIN_CONFIG).replace_path("trainer.log_dir", log_dir)
    loader, _ = load_dataloader(None, "train", None, cfg, seed=0)
    batch = next(iter(loader))
    if batch.shape != (STAGE2_B, 256, 256, 3):
        raise AssertionError(f"(p) batch {batch.shape}")
    worker = out["worker"]
    reset_counts()
    t0 = time.perf_counter()
    worker.log_artifacts(torch.from_numpy(batch[:LOG_B]).cuda(), 0, 1)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    launches = read_counts()
    grid = os.path.join(worker.run_dir, "transformer_epoch0_1.jpg")
    if {k: v for k, v in launches.items() if v} != {"gpt_decode_stack": 2 * N} \
            or not os.path.exists(grid):
        raise AssertionError(f"(p) log_artifacts at batch {LOG_B}: launches {launches}, "
                             f"grid {os.path.exists(grid)}")
    print(f"(p) log_artifacts at batch {LOG_B} (input, rec, half and full samples): "
          f"{launches['gpt_decode_stack']} decode-stack launches, {sec:.3f} s; {card}")
    del out, worker
    torch.cuda.empty_cache()
    worker = VQTransformerWorker(cfg, log_dir, device="cuda")
    worker.init_state()
    numbers = stage2_step_times("p", GPT_TRAIN_CONFIG, worker, torch.from_numpy(batch).cuda(),
                                card, tokens=N)
    del worker
    torch.cuda.empty_cache()
    numbers.update(cli_numbers(cli_epochs("p", GPT_TRAIN_CONFIG, log_dir, STAGE2_EPOCHS,
                                          STAGE2_B)))
    torch.cuda.empty_cache()
    gpt_card_against_cpu(cfg, log_dir, batch[:2], card)
    shutil.rmtree(log_dir)
    return numbers


def diffusion_step_against_cpu(label: str, make_worker, batch, t: torch.Tensor,
                               noise: torch.Tensor, metric_tols: dict, card: str,
                               indices=None) -> None:
    """(q), (r): one diffusion step from the same seeded weights, batch, t
    and noise on the card and on the CPU in f32, and on the CPU in float64
    as the reference of both (``make_worker(device)`` builds the worker,
    whose U-Net, EMA copy and, where it has one, composite are cast):
    ``indices(worker, x)`` (the frozen VQVAE's, where given) at least 99.9%
    equal; each metric within its relative tolerance of ``metric_tols``;
    gradients by (o)'s rule, the CPU's f32 distance the larger of two
    reduction orders (all its threads, and one: through the U-Net's
    BatchNorm backwards the f32 gradients of one order lie several times
    further from float64 than another's, so one CPU run alone does not
    measure f32 rounding); the card's float64 step within 1e-9 of each
    leaf's largest entry of the CPU's (the same function on the card, apart
    from f32 rounding); the U-Net's and the EMA's parameters within 2 lr of
    the CPU's; the running statistics and the EMA's (copied at this step 0)
    within 1e-4. Where a parameter lies more than lr / 10 from the CPU's,
    its float64 gradient must lie within its leaf's f32 rounding of zero
    (the largest distance of an f32 gradient of that leaf from float64's):
    Adam's first step moves an entry by lr times the sign of its gradient,
    so an entry whose gradient f32 cannot tell from zero takes either sign
    on either side. (o)'s "99% of each live leaf within lr / 10" would
    count them instead: a 32-channel BatchNorm leaf with one such entry has
    96.9% within.)"""
    b = batch.shape[0]
    runs = {}
    threads = torch.get_num_threads()
    for device, dtype, n_threads in (("cuda", torch.float32, threads),
                                     ("cpu", torch.float32, threads), ("cpu", torch.float32, 1),
                                     ("cpu", torch.float64, threads),
                                     ("cuda", torch.float64, threads)):
        torch.set_num_threads(n_threads)
        w = make_worker(device)
        state = w.init_state()
        for module in (getattr(w, "composite", None) or state.unet, state.ema):
            module.to(dtype)
        x = torch.from_numpy(batch).to(device, dtype)
        idx = indices(w, x).cpu() if indices else torch.zeros(1)
        t0 = time.perf_counter()
        _, metrics = w.train_step(state, x, t=t.to(device), noise=noise.to(device, dtype))
        metrics = {k: float(v) for k, v in metrics.items()}
        sec = time.perf_counter() - t0
        runs[device, dtype, n_threads] = (
            idx, metrics, {k: v.cpu() for k, v in state.unet.state_dict().items()},
            {k: p.grad.cpu().double() for k, p in state.unet.named_parameters()},
            {k: v.cpu() for k, v in state.ema.state_dict().items()}, sec)
        lr = w.lr_fn(0)
        del w, state
    torch.set_num_threads(threads)
    (gi, gm, gp, gg, ge, _), (ci, cm, cp, cg, ce, csec) = runs["cuda", torch.float32, threads], \
        runs["cpu", torch.float32, threads]
    same = (gi == ci).double().mean().item()
    ref = runs["cpu", torch.float64, threads][3]
    live = gradients_against_float64(label, gg, [cg, runs["cpu", torch.float32, 1][3]], ref)
    card64 = runs["cuda", torch.float64, threads][3]
    gap64 = max(float((card64[k] - ref[k]).abs().max()) / float(ref[k].abs().max())
                for k in live)
    print(f"({label}) the card's float64 step against the CPU's: gradients within {gap64:.3e} "
          f"of each live leaf's largest entry (tol 1e-9)")
    rel = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-6) for k in cm}
    rounding = {k: max(float((g[k] - ref[k]).abs().max())
                       for g in (gg, cg, runs["cpu", torch.float32, 1][3])) for k in live}
    checks = {}
    for part, got, want in (("U-Net", gp, cp), ("EMA", ge, ce)):
        worst, p_worst, near, stats = params_card_against_cpu(got, want, live, lr)
        far = {k: (got[k].double() - want[k].double()).abs() > lr / 10 for k in live}
        unexplained = sum(int((ref[k].abs()[far[k]] > rounding[k]).sum()) for k in live)
        checks[part] = (worst, stats, unexplained)
        print(f"({label}) {part} after one step on the card against the CPU: parameters max diff "
              f"{worst:.3e} (2 lr = {2 * lr:.3e}); {sum(int(m.sum()) for m in far.values())} "
              f"entries of {sum(m.numel() for m in far.values())} more than lr / 10 apart, "
              f"{unexplained} of them with a float64 gradient beyond its leaf's f32 rounding; "
              f"fewest within lr / 10 {p_worst} {100 * near[p_worst]:.3f}%; running statistics "
              f"max diff {stats:.3e}")
    equal = f"{100 * same:.3f}% of {gi.numel()} indices equal; " if indices else ""
    print(f"({label}) one step at batch {b} on the card against the CPU ({csec:.1f} s on the "
          f"CPU): {equal}metrics card {gm}, CPU {cm}; {card}")
    if same < 0.999 or any(rel[k] > tol for k, tol in metric_tols.items()) or gap64 > 1e-9 \
            or any(worst > 2 * lr + 1e-6 or stats > 1e-4 or unexplained
                   for worst, stats, unexplained in checks.values()):
        raise AssertionError(f"({label}) the card's diffusion step departs from the CPU's")


def vqd_card_against_cpu(cfg, log_dir: str, batch, card: str) -> None:
    """(q) one gaussian3d prior step at batch 2 by :func:`diffusion_step_against_cpu`:
    the frozen VQVAE's indices, noise_mse within 1e-4 relative,
    indices_recon within 1e-2 relative (one argmax of 512 flipped at a near
    tie moves it by less)."""
    from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker

    b = batch.shape[0]
    gen = torch.Generator().manual_seed(24)
    t = torch.randint(0, STEPS, (b,), generator=gen)
    noise = torch.randn(b, N, GAUSSIAN_DIM, 1, generator=gen)
    diffusion_step_against_cpu(
        "q", lambda device: VQDiffusionWorker(cfg, log_dir, device=device), batch, t, noise,
        {"noise_mse": 1e-4, "indices_recon": 1e-2}, card,
        indices=lambda w, x: w.composite.encode_to_z(x))


def phase_vqd_train(card: str) -> dict:
    """(q): gaussian3d prior training at full width; returns the step's numbers."""
    import tempfile

    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.data import load_dataloader
    from vq_vae_gan_diffusion_torch.models.shuffle_infer import apply_folded, fold_unet
    from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_vqd_")
    out = run_train_cli("q", VQD_TRAIN_CONFIG, log_dir,
                        {"shuffle_bottleneck": 39 * G3D_HOOK_STEPS,
                         "shuffle_downsample": 4 * G3D_HOOK_STEPS},
                        ("recon_epoch0_0.jpg", "samples_epoch0.jpg"), overrides=G3D_HOOK)
    ema = out["worker"].state.ema
    gen = torch.Generator(device="cuda").manual_seed(25)
    x = torch.randn(B, N, GAUSSIAN_DIM, 1, generator=gen, device="cuda")
    t = torch.randint(0, G3D_HOOK_STEPS, (B,), generator=gen, device="cuda")
    with torch.no_grad():
        ref = ema.eval()(x, None, t)
    err = check_close("(q) the EMA U-Net, kernel route vs module", apply_folded(
        fold_unet(ema), x, t), ref, 1e-3, scale=ref.abs().max().item())
    print(f"(q) the trained EMA U-Net forward {list(x.shape)}, kernel route vs fused_sampler "
          f"False: max abs err {err:.3e}, max |module| {ref.abs().max().item():.3f}")
    del out, ema
    torch.cuda.empty_cache()
    cfg = load_config(VQD_TRAIN_CONFIG).replace_path("trainer.log_dir", log_dir)
    loader, _ = load_dataloader(None, "train", None, cfg, seed=0)
    batch = next(iter(loader))
    if batch.shape != (STAGE2_B, 256, 256, 3):
        raise AssertionError(f"(q) batch {batch.shape}")
    worker = VQDiffusionWorker(cfg, log_dir, device="cuda", num_iters_per_epoch=len(loader))
    worker.init_state()
    numbers = stage2_step_times("q", VQD_TRAIN_CONFIG, worker, torch.from_numpy(batch).cuda(),
                                card)
    del worker
    torch.cuda.empty_cache()
    numbers.update(cli_numbers(cli_epochs("q", VQD_TRAIN_CONFIG, log_dir, STAGE2_EPOCHS,
                                          STAGE2_B, overrides=G3D_HOOK)))
    torch.cuda.empty_cache()
    vqd_card_against_cpu(cfg, log_dir, batch[:2], card)
    shutil.rmtree(log_dir)
    return numbers


def phase_pixel_train(card: str) -> dict:
    """(r): the pixel-space gaussiandiffusion3d worker at full width (U-Net
    base 64, mults (2, 4) on 28x28x1, 1000 steps); returns the step's
    numbers with the samples' launches and seconds."""
    import tempfile

    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.data import load_dataloader
    from vq_vae_gan_diffusion_torch.models.shuffle_infer import apply_folded, fold_unet
    from vq_vae_gan_diffusion_torch.train.gaussian_diffusion_workers import (
        GaussianDiffusion3DWorker)

    units = unet_unit_shapes(PIXEL_HW, PIXEL_HW, 64, PIXEL_MULTS)
    k1 = sum(kind == "K1" for kind, *_ in units)
    k2 = len(units) - k1
    if k2 != 2:
        raise AssertionError(f"(r) {k2} downsamples a forward, expected 2")
    print(f"(r) the pixel U-Net (base 64, mults {PIXEL_MULTS}) on {PIXEL_HW}x{PIXEL_HW}x1: "
          f"{k1} K1 and {k2} K2 a forward")
    phase_units(card, h=PIXEL_HW, w=PIXEL_HW, label="r", mults=PIXEL_MULTS, batch=PIXEL_SAMPLES)
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_pixel_")
    want = {"shuffle_bottleneck": k1 * STEPS, "shuffle_downsample": k2 * STEPS}
    out = run_train_cli("r", PIXEL_CONFIG, log_dir, want, ("samples_epoch0.jpg",))
    worker = out["worker"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    images = worker.sample(PIXEL_SAMPLES)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    launches = read_counts()
    if launches != {name: want.get(name, 0) for name in launches}:
        raise AssertionError(f"(r) the EMA's samples: launches {launches}, expected {want}")
    if tuple(images.shape) != (PIXEL_SAMPLES, PIXEL_HW, PIXEL_HW, 1) or \
            not torch.isfinite(images).all():
        raise AssertionError(f"(r) samples {tuple(images.shape)} not finite of "
                             f"[{PIXEL_SAMPLES}, {PIXEL_HW}, {PIXEL_HW}, 1]")
    print(f"(r) the EMA's {PIXEL_SAMPLES} samples: {STEPS}-step chain {sample_s:.3f} s "
          f"({1e3 * sample_s / STEPS:.3f} ms a reverse step); {want['shuffle_bottleneck']} K1 "
          f"and {want['shuffle_downsample']} K2 launches; values in "
          f"[{images.min().item():.3f}, {images.max().item():.3f}]; {card}")
    ema = worker.state.ema
    gen = torch.Generator(device="cuda").manual_seed(26)
    x = torch.randn(PIXEL_SAMPLES, PIXEL_HW, PIXEL_HW, 1, generator=gen, device="cuda")
    t = torch.randint(0, STEPS, (PIXEL_SAMPLES,), generator=gen, device="cuda")
    with torch.no_grad():
        ref = ema.eval()(x, None, t)
    err = check_close("(r) the EMA U-Net, kernel route vs module", apply_folded(
        fold_unet(ema), x, t), ref, 1e-3, scale=ref.abs().max().item())
    print(f"(r) the trained EMA U-Net forward {list(x.shape)}, kernel route vs fused_sampler "
          f"False: max abs err {err:.3e}, max |module| {ref.abs().max().item():.3f}")
    del out, worker, ema
    torch.cuda.empty_cache()
    cfg = load_config(PIXEL_CONFIG).replace_path("trainer.log_dir", log_dir)
    loader, _ = load_dataloader(None, "train", None, cfg, seed=0)
    batch = next(iter(loader))
    if batch.shape != (PIXEL_B, PIXEL_HW, PIXEL_HW, 1):
        raise AssertionError(f"(r) batch {batch.shape}")
    worker = GaussianDiffusion3DWorker(cfg, log_dir, device="cuda",
                                       num_iters_per_epoch=len(loader))
    worker.init_state()
    numbers = stage2_step_times("r", PIXEL_CONFIG, worker, torch.from_numpy(batch).cuda(), card)
    numbers.update({"samples": PIXEL_SAMPLES, "sample_s": sample_s, "sample_launches": want})
    del worker
    torch.cuda.empty_cache()
    b = 4
    g = torch.Generator().manual_seed(27)
    t = torch.randint(0, STEPS, (b,), generator=g)
    noise = torch.randn(b, PIXEL_HW, PIXEL_HW, 1, generator=g)
    diffusion_step_against_cpu(
        "r", lambda device: GaussianDiffusion3DWorker(cfg, log_dir, device=device), batch[:b],
        t, noise, {"loss": 1e-4}, card)
    shutil.rmtree(log_dir)
    return numbers


def vqo_card_against_cpu(cfg, log_dir: str, batch, card: str) -> None:
    """(s) one VQ_Official step at batch 1 from the same seeded weights,
    batch, t and Gumbel noise on the card and on the CPU, f32: the frozen
    VQVAE's indices equal; the loss and its metrics within 2e-4 relative
    (tests/test_torch_port_discrete_train.py's bar for one sample's KL
    through the U-Net; at batch 1 the loss is one sample's); the new
    LtState's counts equal, its history within 4e-4 relative (squared
    losses), its accuracy EMAs within 1e-3 (one argmax of 256 flipped at a
    near tie moves one by 0.1 / 256); every U-Net parameter within 2 lr,
    the running statistics within 1e-4 plus 2e-3 of each leaf's largest
    entry (flax-free here, but the init conv's output on the -69 / 0 image
    has a mean near 130 against its spread, so two reduction orders
    differ by about 1e-3 of its variance)."""
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import gumbel_from_uniform
    from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker

    b = batch.shape[0]
    gen = torch.Generator().manual_seed(28)
    t = torch.randint(0, VQO_T, (b,), generator=gen)
    noise = gumbel_from_uniform(torch.rand(b, N, VQO_K, generator=gen))
    runs = {}
    for device in ("cuda", "cpu"):
        w = VQDiffusionWorker(cfg, log_dir, device=device)
        state = w.init_state()
        x = torch.from_numpy(batch).to(device)
        idx = w.composite.encode_to_z(x).cpu()
        t0 = time.perf_counter()
        _, metrics = w.train_step(state, x, t=t.to(device), noise=noise.to(device))
        metrics = {k: float(v) for k, v in metrics.items()}
        sec = time.perf_counter() - t0
        runs[device] = (idx, metrics, [v.cpu() for v in state.lt],
                        {k: v.cpu() for k, v in state.unet.state_dict().items()}, sec)
        lr = w.lr_fn(0)
        del w, state
    (gi, gm, gl, gp, _), (ci, cm, cl, cp, csec) = runs["cuda"], runs["cpu"]
    rel = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-6) for k in cm}
    hist = float(((gl[0] - cl[0]).abs() / cl[0].abs().clamp(min=1e-6)).max())
    acc = max(float((g - c).abs().max()) for g, c in zip(gl[2:], cl[2:]))
    params = max(float((gp[k] - cp[k]).abs().max()) for k in cp
                 if "running" not in k and "num_batches" not in k)
    stats = max(float((gp[k] - cp[k]).abs().max()) - 2e-3 * float(cp[k].abs().max())
                for k in cp if "running" in k)
    print(f"(s) one step at batch {b} on the card against the CPU ({csec:.1f} s on the CPU): "
          f"{int((gi == ci).sum())} of {gi.numel()} indices equal; metrics card {gm}, CPU {cm}; "
          f"LtState: counts {'equal' if torch.equal(gl[1], cl[1]) else 'DIFFERENT'}, history "
          f"{hist:.3e} relative, accuracy EMAs {acc:.3e}; parameters max diff {params:.3e} "
          f"(2 lr = {2 * lr:.3e}); running statistics beyond 2e-3 of their leaf {stats:.3e}; "
          f"{card}")
    if not torch.equal(gi, ci) or max(rel.values()) > 2e-4 or not torch.equal(gl[1], cl[1]) \
            or hist > 4e-4 or acc > 1e-3 or params > 2 * lr + 1e-6 or stats > 1e-4:
        raise AssertionError("(s) the card's VQ_Official step departs from the CPU's")


def phase_vqo_train(card: str) -> dict:
    """(s): VQ_Official prior training at full width (K = 1024 over 256
    tokens, the U-Net on [B, 1024, 256, 1], 1000 steps); returns the step's
    numbers with the peak memory by batch."""
    import tempfile

    from vq_vae_gan_diffusion_torch.config import load_config, resolve_batch_size
    from vq_vae_gan_diffusion_torch.data import load_dataloader
    from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_vqo_")
    want = {"shuffle_bottleneck": 39 * VQO_STEPS, "shuffle_downsample": 4 * VQO_STEPS,
            "discrete_posterior": VQO_STEPS - 1}
    out = run_train_cli("s", VQO_TRAIN_CONFIG, log_dir, want,
                        ("recon_epoch0_0.jpg", "samples_epoch0.jpg"),
                        overrides={"architecture.vqdiffusion.sampling_steps": VQO_STEPS})
    lt = out["worker"].state.lt
    if float(lt.Lt_count.sum()) != 4 or not torch.isfinite(lt.Lt_history).all():
        raise AssertionError(f"(s) LtState after two steps at batch 2: {lt}")
    print(f"(s) LtState after the CLI's two steps: {int(lt.Lt_count.sum())} counts at t = "
          f"{lt.Lt_count.nonzero().flatten().tolist()}")
    del out, lt
    torch.cuda.empty_cache()
    cfg = load_config(VQO_TRAIN_CONFIG).replace_path("trainer.log_dir", log_dir)
    loader, _ = load_dataloader(None, "train", None, cfg, seed=0)
    batch = next(iter(loader))
    b = resolve_batch_size(cfg)
    if batch.shape != (b, 256, 256, 3):
        raise AssertionError(f"(s) batch {batch.shape}")
    peaks = {}
    for small in (2, 4):
        w = VQDiffusionWorker(cfg, log_dir, device="cuda")
        w.init_state()
        x = torch.from_numpy(batch[:small]).cuda()
        w.train_step(w.state, x, w.generator)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        w.train_step(w.state, x, w.generator)
        torch.cuda.synchronize()
        peaks[small] = torch.cuda.max_memory_allocated() / 2 ** 30
        del w, x
        torch.cuda.empty_cache()
    slope = (peaks[4] - peaks[2]) / 2
    fits = int(2 + (70 - peaks[2]) // slope)
    print(f"(s) peak memory of a warm train_step: batch 2 {peaks[2]:.3f} GiB, batch 4 "
          f"{peaks[4]:.3f} GiB, {slope:.3f} GiB an image: under 70 GiB up to batch {fits}; "
          f"the config's batch {b}; {card}")
    if b > fits:
        raise AssertionError(f"(s) batch {b} would need more than 70 GiB")
    worker = VQDiffusionWorker(cfg, log_dir, device="cuda", num_iters_per_epoch=len(loader))
    worker.init_state()
    numbers = stage2_step_times("s", VQO_TRAIN_CONFIG, worker, torch.from_numpy(batch).cuda(),
                                card)
    numbers["peak_gib_by_batch"] = peaks
    if numbers["peak_gib"] > 70:
        raise AssertionError(f"(s) peak {numbers['peak_gib']:.3f} GiB at batch {b}")
    del worker
    torch.cuda.empty_cache()
    vqo_card_against_cpu(cfg, log_dir, batch[:1], card)
    shutil.rmtree(log_dir)
    return numbers


def phase_demo(card: str) -> dict:
    """(t): B6 and B7 against their plain versions at the demo's shape
    (logits [4, 64, 64], K = 65, 20 steps, gamma_T 0.9), as (i) checks
    them; then the demo ``python -m vq_vae_gan_diffusion_torch.vq_diffusion``
    on the card under ``--fused-posterior on`` and ``prng``: its sample (19
    structured steps) and fast_sample (4) launch 23 B6 or 23 B7 and nothing
    else; its trained prior's sample with the same noise under on and off
    (at least 99% of indices equal). Returns each mode's launches."""
    from vq_vae_gan_diffusion_torch import vq_diffusion
    from vq_vae_gan_diffusion_torch.diffusion.discrete import make_discrete_schedule
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import (
        fused_posterior_sample, fused_posterior_sample_prng, gather_posterior_coefs,
        gumbel_from_bits, gumbel_from_uniform, philox_bits, posterior_scores)

    b, n, k, steps = 4, 64, 65, 20
    trunc = int(k * 0.86)
    gen = torch.Generator(device="cuda").manual_seed(29)
    sched = make_discrete_schedule(steps, k, 0.9).to("cuda")
    gumbel = gumbel_from_uniform(torch.rand(b, n, k, generator=gen, device="cuda"))
    seeds = torch.randint(-2 ** 31, 2 ** 31, (b, 2), dtype=torch.int32, generator=gen,
                          device="cuda")
    x_t = torch.randint(0, k, (b, n), generator=gen, device="cuda")
    x_t[:, ::5] = k - 1
    logits = 3 * torch.randn(b, n, k - 1, generator=gen, device="cuda")
    gap = 0.0
    for t in (0, 1, steps // 2, steps - 1):
        coefs = gather_posterior_coefs(sched, torch.full((b,), t, device="cuda"), steps)
        for trunc_k in (0, trunc):
            for fn, noise, g in ((fused_posterior_sample, gumbel, gumbel),
                                 (fused_posterior_sample_prng, seeds,
                                  gumbel_from_bits(philox_bits(seeds, n, k)))):
                got = fn(logits, x_t, coefs, noise, trunc_k=trunc_k)
                torch.cuda.synchronize()
                gap = max(gap, check_indices(f"(t) {fn.__name__} t={t} trunc_k={trunc_k}", got,
                                             posterior_scores(logits, x_t, coefs, g, trunc_k)))
    print(f"(t) B6 and B7 at the demo's logits [{b}, {n}, {k - 1}], t in {{0, 1, {steps // 2}, "
          f"{steps - 1}}}, trunc_k 0 and {trunc}: every check passes, max score gap {gap:.3e}")
    none = {name: 0 for name in kernel_wrappers()}
    structured = steps - 1 + len(range(steps - 1, -1, -4)) - 1
    counted = {}
    for mode, name in (("on", "discrete_posterior"), ("prng", "discrete_posterior_prng")):
        reset_counts()
        t0 = time.perf_counter()
        out = vq_diffusion.run(["--device", "cuda", "--fused-posterior", mode])
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = read_counts()
        if launches != dict(none, **{name: structured}):
            raise AssertionError(f"(t) {mode}: launches {launches}, expected {structured} {name}")
        for idx in (out["samples"], out["fast"]):
            if tuple(idx.shape) != (4, 8, 8) or int(idx.min()) < 0 or int(idx.max()) > 63:
                raise AssertionError(f"(t) {mode}: indices {tuple(idx.shape)} not [4, 8, 8] in "
                                     "[0, 63]")
        if not all(math.isfinite(v) for v in out["losses"]):
            raise AssertionError(f"(t) {mode}: losses {out['losses']}")
        counted[mode] = launches
        print(f"(t) the demo under --fused-posterior {mode}: 20 Adam steps, loss "
              f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}; {launches[name]} {name} "
              f"launches (sample 19, fast_sample 4); {sec:.2f} s in all; {card}")
    m = out["model"]
    u_noise = [gumbel_from_uniform(torch.rand(4, n, k, generator=gen, device="cuda"))
               for _ in range(steps)]
    idx = {}
    for mode in (True, False):
        m.diffusion.fused_posterior = mode
        idx[mode] = m.sample(4, step_gumbel=u_noise)
    agree = (idx[True] == idx[False]).float().mean().item()
    print(f"(t) the trained demo prior's sample, same noise, fused_posterior on against off: "
          f"{100 * agree:.2f}% of 4 x {n} indices equal")
    if agree < 0.99:
        raise AssertionError(f"(t) posterior kernel and plain ops agree on only {100 * agree:.2f}%")
    return counted


def no_launches(label: str) -> None:
    """Fails unless no kernel was launched since the counts were set to 0."""
    launches = read_counts()
    if any(launches.values()):
        raise AssertionError(f"({label}) launches {launches}, expected none")


def stage2_batch(label: str, config: str, log_dir: str, shape: tuple):
    """The first batch of ``config``'s train split (synthetic where the data
    is not on disk), and the config with ``log_dir``."""
    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.data import load_dataloader

    cfg = load_config(config).replace_path("trainer.log_dir", log_dir)
    loader, _ = load_dataloader(None, "train", None, cfg, seed=0)
    batch = next(iter(loader))
    if batch.shape != shape:
        raise AssertionError(f"({label}) batch {batch.shape}, expected {shape}")
    return cfg, loader, batch


def phase_gaussian2d(card: str) -> dict:
    """(u): the gaussian2d prior at full width; returns the step's numbers
    with the chain's seconds."""
    import tempfile

    from vq_vae_gan_diffusion_torch import generate
    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import VQDiffusionComposite
    from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker

    argv = ["--config", G2D_CONFIG, "--n-samples", str(B), "--seed", "42", "--device", "cuda"]
    g2d_steps = {"architecture.vqdiffusion.sampling_steps": G2D_STEPS}
    chain = {}
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = generate.run(argv, overrides=g2d_steps)
        total = time.perf_counter() - t0
        no_launches("u")
        idx, images = out["indices"], out["images"]
        if tuple(idx.shape) != (B, N) or int(idx.min()) < 0 or int(idx.max()) >= 1024:
            raise AssertionError(f"(u) indices {tuple(idx.shape)} not [16, 256] in [0, 1024)")
        if tuple(images.shape) != (B, 256, 256, 3) or not torch.isfinite(images).all():
            raise AssertionError(f"(u) images {tuple(images.shape)} not finite of [16,256,256,3]")
        sec = out["seconds"]
        chain[run] = sec["sample"]
        print(f"(u) {run}: {G2D_STEPS}-step DDIM chain of 16 {sec['sample']:.3f} s "
              f"({1e3 * sec['sample'] / G2D_STEPS:.3f} ms a reverse step: one U-Net forward and the "
              f"update); VQVAE decode {sec['decode']:.3f} s; total {total:.2f} s; max memory "
              f"allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
              f"{len(set(idx.flatten().tolist()))} distinct indices; no kernel launch; {card}")

    comp = VQDiffusionComposite(load_config(G2D_CONFIG))
    comp.unet.init_weights(torch.Generator().manual_seed(31))
    gen = torch.Generator().manual_seed(32)
    init = torch.randint(0, 1024, (1, N), generator=gen)
    # the chain on the CPU, cut to G2D_STEPS of the config's DDIM steps
    comp.prior.cfg = comp.prior.cfg._replace(sampling_timesteps=G2D_STEPS)
    noise = [torch.randn(1, N, GAUSSIAN_DIM, generator=gen) for _ in range(G2D_STEPS)]
    idx, secs = {}, {}
    for device in ("cuda", "cpu"):
        comp.unet.to(device)
        comp.prior.to(device)
        t0 = time.perf_counter()
        idx[device] = comp.sample(1, init_indices=init.to(device),
                                  step_noise=[n.to(device) for n in noise]).cpu()
        secs[device] = time.perf_counter() - t0
    agree = (idx["cuda"] == idx["cpu"]).float().mean().item()
    print(f"(u) one sample's {G2D_STEPS}-step chain from the same indices and noise, card "
          f"{secs['cuda']:.2f} s against CPU {secs['cpu']:.2f} s: {100 * agree:.2f}% of {N} "
          f"indices equal")
    if agree < 0.99:
        raise AssertionError(f"(u) card and CPU agree on only {100 * agree:.2f}% of indices")
    del comp

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_g2d_")
    run_train_cli("u", G2D_TRAIN_CONFIG, log_dir, {}, ("recon_epoch0_0.jpg", "samples_epoch0.jpg"),
                  overrides=g2d_steps)
    torch.cuda.empty_cache()
    cfg, loader, batch = stage2_batch("u", G2D_TRAIN_CONFIG, log_dir, (STAGE2_B, 256, 256, 3))
    worker = VQDiffusionWorker(cfg, log_dir, device="cuda", num_iters_per_epoch=len(loader))
    worker.init_state()
    numbers = stage2_step_times("u", G2D_TRAIN_CONFIG, worker, torch.from_numpy(batch).cuda(),
                                card)
    numbers.update({"chain_s_cold": chain["cold"], "chain_s_warm": chain["warm"],
                    "samples": B, "ddim_steps": G2D_STEPS})
    del worker
    torch.cuda.empty_cache()
    b = 2
    g = torch.Generator().manual_seed(34)
    diffusion_step_against_cpu(
        "u", lambda device: VQDiffusionWorker(cfg, log_dir, device=device), batch[:b],
        torch.randint(0, STEPS, (b,), generator=g), torch.randn(b, N, GAUSSIAN_DIM, generator=g),
        {"loss": 1e-4}, card, indices=lambda w, x: w.composite.encode_to_z(x))
    shutil.rmtree(log_dir)
    return numbers


def phase_vqofficial1d(card: str) -> dict:
    """(v): the VQ_Official prior on its Conv1d U-Net at full width, the
    chain cut to 20 steps; returns the step's numbers with the launches of
    each run."""
    import tempfile

    from vq_vae_gan_diffusion_torch import generate
    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import VQDiffusionComposite
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import (
        fused_posterior_sample, fused_posterior_sample_prng, gather_posterior_coefs,
        gumbel_from_bits, gumbel_from_uniform, philox_bits, posterior_scores,
        reference_posterior_sample)
    from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker

    steps_path = "architecture.vqdiffusion.sampling_steps"
    argv = ["--config", VQO1D_CONFIG, "--n-samples", str(B), "--seed", "42", "--device", "cuda"]
    counted = {}
    for run, mode, name in (("cold", "on", "discrete_posterior"),
                            ("warm", "on", "discrete_posterior"),
                            ("prng", "prng", "discrete_posterior_prng")):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = generate.run(argv + ["--fused-posterior", mode], overrides={steps_path: VQO_STEPS})
        total = time.perf_counter() - t0
        launches = read_counts()
        want = {k: (VQO_STEPS - 1 if k == name else 0) for k in launches}
        if launches != want:
            raise AssertionError(f"(v) {run}: launches {launches}, expected {want}")
        idx, images = out["indices"], out["images"]
        if tuple(idx.shape) != (B, N) or int(idx.min()) < 0 or int(idx.max()) >= VQO_K:
            raise AssertionError(f"(v) indices {tuple(idx.shape)} not [16, 256] in [0, 1024)")
        if tuple(images.shape) != (B, 256, 256, 3) or not torch.isfinite(images).all():
            raise AssertionError(f"(v) images {tuple(images.shape)} not finite of [16,256,256,3]")
        counted[run] = launches[name]
        sec = out["seconds"]
        print(f"(v) {run} (--fused-posterior {mode}): {launches[name]} {name} launches and no "
              f"other; {VQO_STEPS}-step chain {sec['sample']:.3f} s "
              f"({1e3 * sec['sample'] / VQO_STEPS:.3f} ms a reverse step); VQVAE decode "
              f"{sec['decode']:.3f} s; total {total:.2f} s; max memory allocated "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {card}")

    cfg = load_config(VQO1D_CONFIG).replace_path(steps_path, VQO_STEPS)
    comp = VQDiffusionComposite(cfg)
    comp.unet.init_weights(torch.Generator().manual_seed(35))
    comp.unet.cuda()
    prior = comp.bind()
    gen = torch.Generator(device="cuda").manual_seed(36)
    shape = (B, N, VQO_K)
    gumbel = gumbel_from_uniform(torch.rand(shape, generator=gen, device="cuda"))
    seeds = torch.randint(-2 ** 31, 2 ** 31, (B, 2), dtype=torch.int32, generator=gen,
                          device="cuda")
    x_t = torch.randint(0, VQO_K, (B, N), generator=gen, device="cuda")
    x_t[:, ::5] = VQO_K - 1
    gaps = {"discrete_posterior": 0.0, "discrete_posterior_prng": 0.0}
    for t in (0, 1, VQO_T // 2, VQO_T - 1):
        tt = torch.full((B,), t, device="cuda")
        with torch.no_grad():
            logits = prior._raw_logits_idx(x_t, tt)
        coefs = gather_posterior_coefs(prior._s(logits.device), tt, VQO_T)
        for name, fn, noise, g in (
                ("discrete_posterior", fused_posterior_sample, gumbel, gumbel),
                ("discrete_posterior_prng", fused_posterior_sample_prng, seeds,
                 gumbel_from_bits(philox_bits(seeds, N, VQO_K)))):
            got = fn(logits, x_t, coefs, noise)
            torch.cuda.synchronize()
            gaps[name] = max(gaps[name], check_indices(f"(v) {name} t={t}", got,
                                                       posterior_scores(logits, x_t, coefs, g, 0)))
    ms = cuda_ms(lambda: fused_posterior_sample(logits, x_t, coefs, gumbel), reps=50)
    plain_ms = cuda_ms(lambda: reference_posterior_sample(logits, x_t, coefs, gumbel), reps=5)
    print(f"(v) B6 and B7 at this U-Net's logits {list(logits.shape)}, t in {{0, 1, "
          f"{VQO_T // 2}, {VQO_T - 1}}}: every check passes, max score gap "
          f"{max(gaps.values()):.3e}; B6 {ms:.4f} ms a call, plain {plain_ms:.4f} ms; {card}")
    u = torch.rand(shape, generator=gen, device="cuda")
    step_gumbel = [gumbel_from_uniform(torch.rand(shape, generator=gen, device="cuda"))
                   for _ in range(VQO_STEPS)]
    idx = {}
    for mode in (True, False):
        comp.fused_posterior = mode
        idx[mode] = comp.sample(B, init_uniform=u, step_gumbel=step_gumbel)
    same = int((idx[True] == idx[False]).sum())
    print(f"(v) {VQO_STEPS}-step chain, same noise, fused_posterior on against off: {same} of "
          f"{idx[True].numel()} indices equal")
    if same != idx[True].numel():
        raise AssertionError("(v) the kernel route and plain ops sampled different indices")
    del comp, prior, logits
    torch.cuda.empty_cache()

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_vqo1d_")
    hook = {"discrete_posterior": VQO_STEPS - 1}
    run_train_cli("v", VQO1D_TRAIN_CONFIG, log_dir, hook, ("recon_epoch0_0.jpg", "samples_epoch0.jpg"),
                  overrides={steps_path: VQO_STEPS})
    torch.cuda.empty_cache()
    cfg, loader, batch = stage2_batch("v", VQO1D_TRAIN_CONFIG, log_dir, (STAGE2_B, 256, 256, 3))
    worker = VQDiffusionWorker(cfg, log_dir, device="cuda", num_iters_per_epoch=len(loader))
    worker.init_state()
    numbers = stage2_step_times("v", VQO1D_TRAIN_CONFIG, worker, torch.from_numpy(batch).cuda(),
                                card)
    numbers.update({"hook_launches": hook, "generate_launches": counted,
                    "b6_ms": ms, "b6_plain_ms": plain_ms})
    del worker
    torch.cuda.empty_cache()
    shutil.rmtree(log_dir)
    return numbers


def phase_pixel2d(card: str) -> dict:
    """(w): the pixel gaussiandiffusion2d worker on 28x28x1; returns the
    step's numbers with the samples' seconds."""
    import tempfile

    from vq_vae_gan_diffusion_torch.train.gaussian_diffusion_workers import (
        GaussianDiffusion2DWorker)

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_pixel2d_")
    out = run_train_cli("w", PIXEL2D_CONFIG, log_dir, {}, ("Generating_epoch000.jpg",),
                        overrides={"architecture.gaussiandiffusion2d.sampling_steps": G2D_STEPS})
    worker = out["worker"]
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    images = worker.sample()
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    no_launches("w")
    if tuple(images.shape) != (PIXEL2D_SAMPLES, PIXEL_HW, PIXEL_HW) or \
            not torch.isfinite(images).all():
        raise AssertionError(f"(w) samples {tuple(images.shape)} not finite of "
                             f"[{PIXEL2D_SAMPLES}, {PIXEL_HW}, {PIXEL_HW}]")
    print(f"(w) the EMA's {PIXEL2D_SAMPLES} samples: {G2D_STEPS}-step DDIM chain {sample_s:.3f} s "
          f"({1e3 * sample_s / G2D_STEPS:.3f} ms a reverse step); values in "
          f"[{images.min().item():.3f}, {images.max().item():.3f}]; {card}")
    del out, worker
    torch.cuda.empty_cache()
    cfg, _, batch = stage2_batch("w", PIXEL2D_CONFIG, log_dir, (PIXEL_B, PIXEL_HW, PIXEL_HW, 1))
    worker = GaussianDiffusion2DWorker(cfg, log_dir, device="cuda")
    worker.init_state()
    numbers = stage2_step_times("w", PIXEL2D_CONFIG, worker, torch.from_numpy(batch).cuda(),
                                card)
    numbers.update({"samples": PIXEL2D_SAMPLES, "sample_s": sample_s, "ddim_steps": G2D_STEPS})
    del worker
    torch.cuda.empty_cache()
    shutil.rmtree(log_dir)
    return numbers


def phase_continuous(card: str) -> dict:
    """(x): c_vqdiffusion and v_vqdiffusion at full width; returns each
    model's step numbers with its samples' seconds."""
    import tempfile

    from vq_vae_gan_diffusion_torch.train.continuous_vq_worker import (
        ContinuousVQDiffusionWorker)

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_cvq_")
    numbers = {}
    for model, config in CONTINUOUS_CONFIGS.items():
        cfg, _, batch = stage2_batch("x", config, log_dir, (STAGE2_B, 256, 256, 3))
        worker = ContinuousVQDiffusionWorker(cfg, log_dir, device="cuda")
        worker.init_state()
        if worker.composite.sampling_timesteps < CONTINUOUS_STEPS:
            raise AssertionError(f"(x) {model}: {worker.composite.sampling_timesteps} DDIM steps")
        worker.composite.sampling_timesteps = CONTINUOUS_STEPS
        numbers[model] = stage2_step_times("x", config, worker, torch.from_numpy(batch).cuda(),
                                           card)
        reset_counts()
        out = worker.generate_images(n_samples=B)
        no_launches("x")
        idx, images = out["indices"], out["images"]
        if tuple(idx.shape) != (B, N) or int(idx.min()) < 0 or int(idx.max()) >= 1024:
            raise AssertionError(f"(x) {model}: indices {tuple(idx.shape)} not [16, 256] in "
                                 "[0, 1024)")
        if tuple(images.shape) != (B, 256, 256, 3) or not torch.isfinite(images).all():
            raise AssertionError(f"(x) {model}: images {tuple(images.shape)} not finite")
        sec = out["seconds"]
        steps = CONTINUOUS_STEPS
        numbers[model].update({"samples": B, "ddim_steps": steps, "sample_s": sec["sample"],
                               "decode_s": sec["decode"]})
        print(f"(x) {model}: the EMA's {B} samples, {steps}-step DDIM chain {sec['sample']:.3f} s "
              f"({1e3 * sec['sample'] / steps:.3f} ms a reverse step), VQVAE decode "
              f"{sec['decode']:.3f} s; {len(set(idx.flatten().tolist()))} distinct indices; "
              f"{card}")
        del worker
        torch.cuda.empty_cache()
    shutil.rmtree(log_dir)
    return numbers


def vae_card_against_cpu(cfg, log_dir: str, batch, card: str) -> None:
    """(y) one VAE step from the same seeded weights, batch and ε on the card
    and on the CPU in f32, and on the CPU in float64 as the reference of
    both, by (q)'s rule: each metric within 1e-4 relative; gradients by
    (o)'s rule; the card's float64 step within 1e-9 of each live leaf's
    largest entry of the CPU's; every parameter within 2 lr of the CPU's,
    and where one lies more than lr / 10 away, its float64 gradient within
    its leaf's f32 rounding of zero (Adam's first step moves an entry by
    lr times its gradient's sign)."""
    from vq_vae_gan_diffusion_torch.train.vae_worker import VAEWorker

    b = batch.shape[0]
    eps = torch.randn(b, VAE_LATENT, VAE_LATENT, 256, generator=torch.Generator().manual_seed(41))
    runs = {}
    for device, dtype in (("cuda", torch.float32), ("cpu", torch.float32),
                          ("cpu", torch.float64), ("cuda", torch.float64)):
        w = VAEWorker(cfg, log_dir, device=device)
        state = w.init_state()
        state.vae.to(dtype)
        x = torch.from_numpy(batch).to(device, dtype)
        t0 = time.perf_counter()
        _, metrics = w.train_step(state, x, eps=eps.to(device, dtype))
        metrics = {k: float(v) for k, v in metrics.items()}
        sec = time.perf_counter() - t0
        runs[device, dtype] = (metrics, {k: v.cpu() for k, v in state.vae.state_dict().items()},
                               {k: p.grad.cpu().double() for k, p in state.vae.named_parameters()},
                               sec)
        lr = w.lr
        del w, state
    (gm, gp, gg, _), (cm, cp, cg, csec) = runs["cuda", torch.float32], runs["cpu", torch.float32]
    ref = runs["cpu", torch.float64][2]
    live = gradients_against_float64("y", gg, [cg], ref)
    card64 = runs["cuda", torch.float64][2]
    gap64 = max(float((card64[k] - ref[k]).abs().max()) / float(ref[k].abs().max())
                for k in live)
    rel = {k: abs(gm[k] - cm[k]) / max(abs(cm[k]), 1e-6) for k in cm}
    rounding = {k: max(float((g[k] - ref[k]).abs().max()) for g in (gg, cg)) for k in live}
    worst, p_worst, near, _ = params_card_against_cpu(gp, cp, live, lr)
    far = {k: (gp[k].double() - cp[k].double()).abs() > lr / 10 for k in live}
    unexplained = sum(int((ref[k].abs()[far[k]] > rounding[k]).sum()) for k in live)
    print(f"(y) one step at batch {b} on the card against the CPU ({csec:.1f} s on the CPU, f32; "
          f"{runs['cpu', torch.float64][3]:.1f} s in float64): metrics card {gm}, CPU {cm}; the "
          f"card's float64 step within {gap64:.3e} of the CPU's (tol 1e-9); parameters max diff "
          f"{worst:.3e} (2 lr = {2 * lr:.3e}); {sum(int(m.sum()) for m in far.values())} entries "
          f"more than lr / 10 apart, {unexplained} of them with a float64 gradient beyond its "
          f"leaf's f32 rounding; fewest within lr / 10 {p_worst} {100 * near[p_worst]:.3f}%; "
          f"{card}")
    if max(rel.values()) > 1e-4 or gap64 > 1e-9 or worst > 2 * lr + 1e-6 or unexplained:
        raise AssertionError("(y) the card's VAE step departs from the CPU's")


def phase_vae(card: str) -> dict:
    """(y): the VAE on training_config_large.yml at full width; returns the
    step's numbers with generate's seconds."""
    import tempfile

    from vq_vae_gan_diffusion_torch import generate
    from vq_vae_gan_diffusion_torch.train.vae_worker import VAEWorker

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_vae_")
    run_train_cli("y", VAE_CONFIG, log_dir, {},
                  ("reconstruction.gif", "samples_epoch0.jpg", "val_recon_epoch0.jpg"))
    torch.cuda.empty_cache()
    argv = ["--config", VAE_CONFIG, "--n-samples", str(B), "--seed", "42", "--device", "cuda"]
    gen_s = {}
    for run in ("cold", "warm"):
        torch.cuda.reset_peak_memory_stats()
        reset_counts()
        t0 = time.perf_counter()
        out = generate.run(argv, overrides={"trainer.log_dir": log_dir})
        gen_s[run] = time.perf_counter() - t0
        no_launches("y")
        images, recon, sec = out["images"], out["reconstructions"], out["seconds"]
        if tuple(images.shape) != (B, VAE_SAMPLE_HW, VAE_SAMPLE_HW, 3) or \
                not torch.isfinite(images).all():
            raise AssertionError(f"(y) samples {tuple(images.shape)} not finite of "
                                 f"[{B}, {VAE_SAMPLE_HW}, {VAE_SAMPLE_HW}, 3]")
        if tuple(recon.shape) != (B, 256, 256, 3) or not torch.isfinite(recon).all():
            raise AssertionError(f"(y) reconstructions {tuple(recon.shape)} not finite")
        print(f"(y) generate {run}: {B} samples z ~ N(0, I) [{B}, 32, 32, 256] decoded to "
              f"{VAE_SAMPLE_HW}x{VAE_SAMPLE_HW} in {sec['sample']:.3f} s, {B} val "
              f"reconstructions in {sec['reconstruct']:.3f} s; total {gen_s[run]:.2f} s; max "
              f"memory allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; no kernel "
              f"launch; {card}")
    del out, images, recon
    torch.cuda.empty_cache()
    cfg, _, batch = stage2_batch("y", VAE_CONFIG, log_dir, (VAE_B, 256, 256, 3))
    worker = VAEWorker(cfg, log_dir, device="cuda")
    worker.init_state()
    # one profiled step: its 9,000 kernel launches make the profiler's
    # window slow to read back
    numbers = stage2_step_times("y", VAE_CONFIG, worker, torch.from_numpy(batch).cuda(), card,
                                profiled=1)
    numbers.update({"generate_s_cold": gen_s["cold"], "generate_s_warm": gen_s["warm"],
                    "samples": B, "sample_hw": VAE_SAMPLE_HW})
    del worker
    torch.cuda.empty_cache()
    vae_card_against_cpu(cfg, log_dir, batch[:2], card)
    shutil.rmtree(log_dir)
    return numbers


def phase_pixel_ddpm(card: str) -> dict:
    """(z): ``python -m vq_vae_gan_diffusion_torch.train_diffusion`` at its
    defaults; returns the step's numbers with the CLI's and the samples'
    seconds."""
    import logging
    import os
    import tempfile

    from vq_vae_gan_diffusion_torch import train_diffusion as tdiff

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_ddpm_")
    reset_counts()
    t0 = time.perf_counter()
    out = tdiff.run(["--debug", "--log-dir", log_dir, "--data-root", log_dir])
    cli_s = time.perf_counter() - t0
    no_launches("z")
    state, save_dir, samples = out["state"], out["save_dir"], out["samples"]
    ckpt = os.path.join(save_dir, "ckpt", f"step_{state.step:08d}.pth")
    if state.step != 11 or not all(math.isfinite(v) for v in out["losses"]) or \
            not os.path.exists(ckpt) or \
            not os.path.exists(os.path.join(save_dir, "samples_epoch_0.png")):
        raise AssertionError(f"(z) train_diffusion --debug: step {state.step}, losses "
                             f"{out['losses']}, files {os.listdir(save_dir)}")
    if tuple(samples.shape) != (4, DDPM_HW, DDPM_HW, 3) or not torch.isfinite(samples).all():
        raise AssertionError(f"(z) --debug samples {tuple(samples.shape)} not finite")
    print(f"(z) train_diffusion --debug on the card: {cli_s:.1f} s; 11 steps at batch 2, mean "
          f"loss {out['losses'][0]:.4f}; {os.path.basename(ckpt)}; 4 samples through 8 DDIM "
          f"steps; no kernel launch")
    del out, state, samples
    trainer = tdiff.PixelDDPM(3, DDPM_HW, sampling_timesteps=DDPM_DDIM, device="cuda")
    state = trainer.init_state()
    loader = tdiff.load_images("cifar10", log_dir, DDPM_B, DDPM_HW, 3, 42,
                               logging.getLogger("chip_smoke"))
    batch = next(iter(loader))
    if batch.shape != (DDPM_B, DDPM_HW, DDPM_HW, 3):
        raise AssertionError(f"(z) batch {batch.shape}")
    numbers = stage2_step_times("z", "train_diffusion.py defaults", trainer,
                                torch.from_numpy(batch).cuda(), card)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    images = trainer.sample(state, DDPM_SAMPLES)
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    no_launches("z")
    if tuple(images.shape) != (DDPM_SAMPLES, DDPM_HW, DDPM_HW, 3) or \
            not torch.isfinite(images).all():
        raise AssertionError(f"(z) samples {tuple(images.shape)} not finite")
    print(f"(z) the EMA's {DDPM_SAMPLES} samples: {DDPM_DDIM}-step DDIM chain {sample_s:.3f} s "
          f"({1e3 * sample_s / DDPM_DDIM:.3f} ms a step); {card}")
    numbers.update({"cli_debug_s": cli_s, "samples": DDPM_SAMPLES, "ddim_steps": DDPM_DDIM,
                    "sample_s": sample_s, "ms_per_ddim_step": 1e3 * sample_s / DDPM_DDIM})
    del trainer, state, images
    torch.cuda.empty_cache()
    b = 4
    g = torch.Generator().manual_seed(51)
    diffusion_step_against_cpu(
        "z", lambda device: tdiff.PixelDDPM(3, DDPM_HW, dropout=0.0, device=device), batch[:b],
        torch.randint(0, 1000, (b,), generator=g), torch.randn(b, DDPM_HW, DDPM_HW, 3, generator=g),
        {"loss": 1e-4}, card)
    shutil.rmtree(log_dir)
    return numbers


def assert_all_f32(label: str, *objs) -> int:
    """Fails unless every floating tensor of the modules, optimizers and
    trees is f32; returns how many there were."""
    seen = 0

    def walk(node, path):
        nonlocal seen
        if isinstance(node, torch.Tensor):
            if node.is_floating_point():
                seen += 1
                if node.dtype != torch.float32:
                    raise AssertionError(f"({label}) {path} is {node.dtype}, not f32")
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
    for i, obj in enumerate(objs):
        walk(obj.state_dict() if hasattr(obj, "state_dict") else obj, f"#{i}")
    return seen


def posterior_at_hook(card: str, dtype: torch.dtype) -> dict:
    """(aa) B6 on the training hook's logits [16, 256, 1023] in ``dtype``
    against its plain version by (i)'s rule, at three t; ms a call issued
    one by one, plain ms and bound."""
    from vq_vae_gan_diffusion_torch.diffusion.discrete import make_discrete_schedule
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import (
        fused_posterior_sample, gather_posterior_coefs, gumbel_from_uniform, posterior_scores,
        reference_posterior_sample)
    gen = torch.Generator(device="cuda").manual_seed(31)
    sched = make_discrete_schedule(VQO_T, VQO_K, 0.99999).to("cuda")
    gumbel = gumbel_from_uniform(torch.rand(B, N, VQO_K, generator=gen, device="cuda"))
    x_t = torch.randint(0, VQO_K, (B, N), generator=gen, device="cuda")
    x_t[:, ::5] = VQO_K - 1
    logits = (3 * torch.randn(B, N, VQO_K - 1, generator=gen, device="cuda")).to(dtype)
    gap = 0.0
    for t in (0, VQO_T // 2, VQO_T - 1):
        coefs = gather_posterior_coefs(sched, torch.full((B,), t, device="cuda"), VQO_T)
        got = fused_posterior_sample(logits, x_t, coefs, gumbel)
        torch.cuda.synchronize()
        gap = max(gap, check_indices(f"(aa) discrete_posterior {dtype} t={t}", got,
                                     posterior_scores(logits, x_t, coefs, gumbel, 0)))
    ms = cuda_ms(lambda: fused_posterior_sample(logits, x_t, coefs, gumbel), reps=50)
    plain_ms = cuda_ms(lambda: reference_posterior_sample(logits, x_t, coefs, gumbel), reps=3)
    bound = max(posterior_bound(B, N, VQO_K - 1, dtype, False, 0, card))
    print(f"(aa) discrete_posterior logits [{B}, {N}, {VQO_K - 1}] {dtype}: checks at 3 t pass, "
          f"max score gap {gap:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
          f"{bound:.4f} ms; {card}")
    return {"max_abs_err": gap, "ms": ms, "plain_ms": plain_ms, "bound_ms": bound}


def step_pair(label: str, key: str, worker, batch, card: str, step=None) -> dict:
    """(aa) a warm training step at ``batch`` in f32, then in bf16, on one
    worker: ms a step over 2 after one, images/s, peak GiB, and the device's
    busy share over a profiled step. Prints ``{"<key>_bf16": ...}`` with
    the f32 step beside it."""
    step = step or (lambda: worker.train_step(worker.state, batch, worker.generator)[1])
    rows = {}
    for dtype in (torch.float32, torch.bfloat16):
        worker.dtype = dtype
        step()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        for _ in range(2):
            metrics = step()
        torch.cuda.synchronize()
        ms = 1e3 * (time.perf_counter() - t0) / 2
        peak = torch.cuda.max_memory_allocated() / 2 ** 30
        if not all(math.isfinite(float(v)) for v in metrics.values()):
            raise AssertionError(f"(aa/{label}) {dtype} metrics {metrics}")
        _, busy, _, _ = profile_steps(step, 1)
        rows[dtype] = {"ms_per_step": ms, "images_per_s": 1e3 * batch.shape[0] / ms,
                       "peak_gib": peak, "device_busy_share": busy}
    line = dict(rows[torch.bfloat16], batch=int(batch.shape[0]), dtype="bfloat16",
                f32=rows[torch.float32], card=card)
    print(json.dumps({f"{key}_bf16": line}))
    return line


def grads_against_cpu_bf16(label: str, card_g: dict, cpu_g: dict, cpu32_g: dict) -> tuple:
    """(aa) the bf16 rule's gradient part, the card's bf16 step against the
    CPU's: over the leaves whose norm is above 1e-3 of the largest, each
    has cosine >= 0.99 with the CPU's bf16 gradient or lies no farther from
    the CPU's f32 gradient than three times the CPU's bf16 one; together no
    farther than twice (tests/test_torch_port_bf16.py: bf16 alone moves
    many leaves by more than their size). Returns (leaves, least cosine,
    the card's and the CPU's root summed squared distance from f32)."""
    norms = {k: float(g.double().norm()) for k, g in cpu_g.items()}
    top = max(norms.values())
    live = [k for k in cpu_g if norms[k] > 1e-3 * top]
    card_sq = cpu_sq = 0.0
    least = 1.0
    for k in live:
        g, w, w32 = (d[k].double().flatten().cpu() for d in (card_g, cpu_g, cpu32_g))
        cos = float(g @ w / (g.norm() * w.norm()))
        dist, own = float((g - w32).norm()), float((w - w32).norm())
        if cos < 0.99 and dist > 3 * own:
            raise AssertionError(f"({label}) {k}: cosine {cos:.4f}, card {dist:.3e} from f32, "
                                 f"CPU bf16 {own:.3e}")
        least, card_sq, cpu_sq = min(least, cos), card_sq + dist ** 2, cpu_sq + own ** 2
    if card_sq ** 0.5 > 2 * cpu_sq ** 0.5:
        raise AssertionError(f"({label}) card bf16 gradients {card_sq ** 0.5:.3e} from f32, "
                             f"CPU bf16 {cpu_sq ** 0.5:.3e}")
    return len(live), least, card_sq ** 0.5, cpu_sq ** 0.5


def vqgan_bf16_card_against_cpu(cfg, log_dir: str, batch, card: str) -> None:
    """(aa) one bf16 stage-1 step at batch 2 from the same seeded weights and
    batch on the card and the CPU (with the CPU's f32 step as the
    reference): metrics by the bf16 rule, gradients by its gradient part."""
    from vq_vae_gan_diffusion_torch.train.vqgan_worker import VQGANVQVAEWorker

    runs = {}
    for device, dtype in (("cuda", torch.bfloat16), ("cpu", torch.bfloat16),
                          ("cpu", torch.float32)):
        w = VQGANVQVAEWorker(cfg, log_dir, device=device, dtype=dtype)
        w.state = w.init_state()
        _, m = w.train_step(w.state, torch.from_numpy(batch).to(device), w.generator)
        grads = {f"vqvae.{k}": p.grad.detach().cpu() for k, p in w.state.vqvae.named_parameters()}
        if w.state.disc is not None:
            grads.update({f"disc.{k}": p.grad.detach().cpu()
                          for k, p in w.state.disc.named_parameters()})
        runs[(device, dtype)] = ({k: float(v) for k, v in m.items()}, grads)
        del w
    (mc, gc), (m16, g16), (m32, g32) = (runs[("cuda", torch.bfloat16)],
                                        runs[("cpu", torch.bfloat16)],
                                        runs[("cpu", torch.float32)])
    for k in m16:
        tol = max(2 * abs(m16[k] - m32[k]), 1e-2 * abs(m32[k]))
        if abs(mc[k] - m16[k]) > tol:
            raise AssertionError(f"(aa) {k}: card bf16 {mc[k]!r}, CPU bf16 {m16[k]!r}, "
                                 f"CPU f32 {m32[k]!r}")
    leaves, least, card_d, cpu_d = grads_against_cpu_bf16("aa", gc, g16, g32)
    print(f"(aa) one bf16 step at batch {batch.shape[0]}, card against CPU: metrics within the "
          f"bf16 rule ({mc}); {leaves} live gradient leaves, least cosine {least:.4f}, the "
          f"card's bf16 {card_d:.3e} from the CPU's f32 gradients, the CPU's bf16 {cpu_d:.3e}; "
          f"{card}")


def phase_bf16(card: str) -> None:
    """(aa) ``--bf16`` on the card: the hook-shaped bf16 kernel calls against
    their plain versions; the train CLI in --debug --bf16 on (o), (p), (q),
    (s) (hooks cut to 20 steps) and (v), and train_diffusion --debug --bf16,
    each with the f32 phase's launch counts and the launches of each
    kernel's bf16 instantiation, then every parameter, optimizer state and
    checkpoint tensor f32; a warm bf16 step beside the f32 one at each f32
    phase's batch; one bf16 step card against CPU."""
    import glob
    import os
    import tempfile

    from vq_vae_gan_diffusion_torch import train_diffusion as tdiff
    from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker
    from vq_vae_gan_diffusion_torch.train.vq_transformer_worker import VQTransformerWorker
    from vq_vae_gan_diffusion_torch.train.vqgan_worker import VQGANVQVAEWorker

    t_phase = time.perf_counter()
    bf16 = torch.bfloat16
    gpt_decode_batch4(card, bf16, "aa")
    phase_units(card, label="aa", kernel_reps=5, plain_reps=1, dtypes=(bf16,))
    phase_units(card, h=VQO_K, w=N, label="aa", kernel_reps=5, plain_reps=1, dtypes=(bf16,))
    posterior_at_hook(card, bf16)
    torch.cuda.empty_cache()

    log_dir = tempfile.mkdtemp(prefix="chip_smoke_bf16_")
    steps_path = "architecture.vqdiffusion.sampling_steps"
    k1, k2, b6 = "shuffle_bottleneck", "shuffle_downsample", "discrete_posterior"
    # (label, config, the f32 phase's launches, of them in bf16, files, overrides): each
    # hook hands its kernels the dtype the JAX hook gives them; VQ_Official's folded
    # forward returns its input's dtype (the f32 log-onehot; JAX: .astype(x.dtype)), so
    # its B6 reads f32 logits, where the Conv1d U-Net's (v) gives bf16 ones
    runs = (("o", TRAIN_CONFIG, {}, {}, ("reconstruction.gif",), {}),
            ("p", GPT_TRAIN_CONFIG, {"gpt_decode_stack": 3 * N}, {"gpt_decode_stack": 3 * N},
             ("transformer_epoch0_0.jpg", "samples_epoch0.jpg"), {}),
            ("q", VQD_TRAIN_CONFIG, {k1: 39 * G3D_HOOK_STEPS, k2: 4 * G3D_HOOK_STEPS},
             {k1: 39 * G3D_HOOK_STEPS, k2: 4 * G3D_HOOK_STEPS},
             ("recon_epoch0_0.jpg", "samples_epoch0.jpg"), G3D_HOOK),
            ("s", VQO_TRAIN_CONFIG, {k1: 39 * VQO_STEPS, k2: 4 * VQO_STEPS, b6: VQO_STEPS - 1},
             {k1: 39 * VQO_STEPS, k2: 4 * VQO_STEPS}, ("recon_epoch0_0.jpg", "samples_epoch0.jpg"),
             {steps_path: VQO_STEPS}),
            ("v", VQO1D_TRAIN_CONFIG, {b6: VQO_STEPS - 1}, {b6: VQO_STEPS - 1},
             ("recon_epoch0_0.jpg", "samples_epoch0.jpg"), {steps_path: VQO_STEPS}))
    for label, config, want, want_bf16, files, overrides in runs:
        out = run_train_cli(f"aa/{label}", config, log_dir, want, files, overrides, ("--bf16",))
        got_bf16 = read_bf16_counts()
        if got_bf16 != want_bf16:
            raise AssertionError(f"(aa/{label}) bf16 launches {got_bf16}, expected {want_bf16}")
        worker = out["worker"]
        if worker.dtype != bf16:
            raise AssertionError(f"(aa/{label}) worker dtype {worker.dtype}")
        ckpt = glob.glob(os.path.join(out["run_dir"], "ckpt", "step_*.pth"))[0]
        n = assert_all_f32(f"aa/{label}", worker.checkpoint_tree(),
                           torch.load(ckpt, weights_only=True))
        print(f"(aa/{label}) launches in bf16: {got_bf16}; {n} floating tensors of the state "
              "and the checkpoint, every one f32")
        del out, worker
        torch.cuda.empty_cache()
    reset_counts()
    out = tdiff.run(["--debug", "--bf16", "--log-dir", log_dir, "--data-root", log_dir])
    no_launches("aa/z")
    state = out["state"]
    ckpt = os.path.join(out["save_dir"], "ckpt", f"step_{state.step:08d}.pth")
    n = assert_all_f32("aa/z", state.unet, state.ema, state.opt,
                       torch.load(ckpt, weights_only=True))
    if out["trainer"].dtype != bf16 or not all(math.isfinite(v) for v in out["losses"]):
        raise AssertionError(f"(aa/z) dtype {out['trainer'].dtype}, losses {out['losses']}")
    print(f"(aa/z) train_diffusion --debug --bf16: mean loss {out['losses'][0]:.4f}; {n} "
          "floating tensors of the U-Net, its EMA, Adam and the checkpoint, every one f32")
    del out, state
    torch.cuda.empty_cache()

    cfg, _, batch = stage2_batch("aa/o", TRAIN_CONFIG, log_dir, (TRAIN_B, 28, 28, 1))
    w = VQGANVQVAEWorker(cfg, log_dir, device="cuda")
    w.state = w.init_state()
    step_pair("o", "vqgan_train_step", w, torch.from_numpy(batch).cuda(), card)
    del w
    for label, key, config, cls in (("p", "gpt_train_step", GPT_TRAIN_CONFIG, VQTransformerWorker),
                                    ("q", "vqd_train_step", VQD_TRAIN_CONFIG, VQDiffusionWorker),
                                    ("s", "vqofficial_train_step", VQO_TRAIN_CONFIG,
                                     VQDiffusionWorker)):
        torch.cuda.empty_cache()
        cfg_l, _, b_l = stage2_batch(f"aa/{label}", config, log_dir,
                                     (STAGE2_B if label != "s" else 11, 256, 256, 3))
        w = cls(cfg_l, log_dir, device="cuda")
        w.init_state()
        step_pair(label, key, w, torch.from_numpy(b_l).cuda(), card)
        del w
    torch.cuda.empty_cache()
    trainer = tdiff.PixelDDPM(3, DDPM_HW, device="cuda")
    st = trainer.init_state()
    imgs = torch.rand(DDPM_B, DDPM_HW, DDPM_HW, 3, device="cuda") * 2 - 1
    step_pair("z", "pixel_ddpm_train_step", trainer, imgs, card,
              step=lambda: trainer.train_step(st, imgs)[1])
    del trainer, st, imgs
    torch.cuda.empty_cache()
    vqgan_bf16_card_against_cpu(cfg, log_dir, batch[:2], card)
    shutil.rmtree(log_dir)
    print(f"(aa) phase time {time.perf_counter() - t_phase:.1f} s; {card}")


def phase_rest(card: str) -> None:
    """(ab) the rest of the slice: the cross-attention prior at (k)'s width
    on a random cond_emb [16, 77, 512] (CLIP ViT-B/32's text states' shape),
    its launches, the kernel route against plain ops under injected noise,
    one training loss card against CPU; feature_fid card against CPU and
    timed; --profile's trace; SIGTERM to a train CLI subprocess; the loop at
    steps_per_dispatch 1 and 4."""
    import glob
    import os
    import signal
    import subprocess
    import tempfile

    import numpy as np
    import yaml

    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.data.datasets import SyntheticDataset
    from vq_vae_gan_diffusion_torch.data.pipeline import DataLoader
    from vq_vae_gan_diffusion_torch.data.transforms import Preprocessor
    from vq_vae_gan_diffusion_torch.models import transformer_vq_diffusion as tvq_mod
    from vq_vae_gan_diffusion_torch.models.lpips import load_lpips
    from vq_vae_gan_diffusion_torch.ops.discrete_posterior import gumbel_from_uniform
    from vq_vae_gan_diffusion_torch.train import cli
    from vq_vae_gan_diffusion_torch.train.vqgan_worker import VQGANVQVAEWorker
    from vq_vae_gan_diffusion_torch.utils.eval_metrics import feature_fid

    t_phase = time.perf_counter()
    geometry = dict(codebook_size=1024, seq_len=N, diffusion_steps=TVQ_T, embedding_dim=512,
                    num_layers=4, num_heads=8, use_text_condition=True)
    tvq = tvq_mod.TransformerVQDiffusion(**geometry)
    tvq.predictor.init_weights(torch.Generator().manual_seed(13))
    tvq = tvq.cuda().eval()
    gen = torch.Generator(device="cuda").manual_seed(14)
    cond = torch.randn(B, 77, 512, generator=gen, device="cuda")
    none = {name: 0 for name in kernel_wrappers()}
    for label, method, mode, expect in (
            ("sample, B6", "sample", True, {"discrete_posterior": TVQ_T - 1}),
            ("fast_sample, B6 at trunc_k 881", "fast_sample", True,
             {"discrete_posterior": (TVQ_T - 1) // 4}),
            ("sample, prng (B7)", "sample", "prng", {"discrete_posterior_prng": TVQ_T - 1})):
        tvq.diffusion.fused_posterior = mode
        reset_counts()
        t0 = time.perf_counter()
        idx = getattr(tvq, method)(B, generator=torch.Generator(device="cuda").manual_seed(12),
                                   cond_emb=cond)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        launches = read_counts()
        if launches != dict(none, **expect):
            raise AssertionError(f"(ab) {label}: launches {launches}, expected {expect}")
        if tuple(idx.shape) != (B, 16, 16) or int(idx.min()) < 0 or int(idx.max()) > 1023:
            raise AssertionError(f"(ab) {label}: indices {tuple(idx.shape)}")
        print(f"(ab) cross-attention prior {label} on cond_emb {list(cond.shape)}: "
              f"{sum(launches.values())} launches, {sec:.3f} s; {card}")
    for method, n_noise in (("sample", TVQ_T), ("fast_sample", (TVQ_T - 1) // 4 + 1)):
        noise = [gumbel_from_uniform(torch.rand(B, N, TVQ_K, generator=gen, device="cuda"))
                 for _ in range(n_noise)]
        idx = {}
        for fused in (True, False):
            tvq.diffusion.fused_posterior = fused
            idx[fused] = getattr(tvq, method)(B, step_gumbel=noise, cond_emb=cond)
        same = int((idx[True] == idx[False]).sum())
        print(f"(ab) {method} on cond_emb, same noise, kernel route against plain ops: {same} "
              f"of {idx[True].numel()} indices equal")
        if same != idx[True].numel():
            raise AssertionError(f"(ab) {method}: the kernel route and plain ops part")
        del noise
    state = {k: v.detach().cpu() for k, v in tvq.predictor.state_dict().items()}
    del tvq
    torch.cuda.empty_cache()
    dropout = tvq_mod.DROPOUT
    tvq_mod.DROPOUT = 0.0                   # dropout off: its masks differ by device
    try:
        losses = {}
        rs = np.random.RandomState(15)
        x0 = torch.from_numpy(rs.randint(0, 1024, (2, N)))
        c2 = torch.from_numpy(rs.standard_normal((2, 77, 512)).astype(np.float32))
        t = torch.from_numpy(rs.randint(0, TVQ_T, (2,)))
        g = gumbel_from_uniform(torch.from_numpy(rs.uniform(size=(2, N, TVQ_K))
                                                 .astype(np.float32)))
        for device in ("cuda", "cpu"):
            m = tvq_mod.TransformerVQDiffusion(**geometry)
            m.predictor.load_state_dict(state, strict=True)
            m = m.to(device)
            loss, _, _ = m.loss(x0.to(device), m.init_lt_state(), t=t.to(device),
                                gumbel=g.to(device), cond_emb=c2.to(device))
            losses[device] = float(loss)
            del m
    finally:
        tvq_mod.DROPOUT = dropout
    rel = abs(losses["cuda"] - losses["cpu"]) / abs(losses["cpu"])
    print(f"(ab) cross-attention prior's training loss at batch 2, dropout off: card "
          f"{losses['cuda']!r}, CPU {losses['cpu']!r}, {rel:.2e} relative (tol 1e-5)")
    if rel > 1e-5:
        raise AssertionError("(ab) the cross-attention loss differs between card and CPU")

    rs = np.random.RandomState(16)
    real = rs.random_sample((32, 64, 64, 3)).astype(np.float32)
    fake = (rs.random_sample((32, 64, 64, 3)) ** 2).astype(np.float32)
    lpips = load_lpips()
    fid_cpu = feature_fid(real, fake, lpips, device="cpu")
    fid_card = feature_fid(real, fake, lpips, device="cuda")
    rel = abs(fid_card - fid_cpu) / abs(fid_cpu)
    print(f"(ab) feature_fid of 2 x 32 images at 64^2: card {fid_card!r}, CPU {fid_cpu!r}, "
          f"{rel:.2e} relative (tol 1e-3)")
    if rel > 1e-3 or not math.isfinite(fid_card):
        raise AssertionError("(ab) feature_fid differs between card and CPU")
    real = rs.random_sample((256, 256, 256, 3)).astype(np.float32)
    fake = rs.random_sample((256, 256, 256, 3)).astype(np.float32)
    feature_fid(real[:64], fake[:64], lpips, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fid = feature_fid(real, fake, lpips, device="cuda")
    sec = time.perf_counter() - t0
    print(f"(ab) feature_fid of 2 x 256 images at 256^2 on the card: {fid!r} in {sec:.3f} s "
          f"(batches of 64, the copies to the card and the 512x512 sqrtm on the host "
          f"included); {card}")
    del real, fake, lpips
    torch.cuda.empty_cache()

    # the SIGTERM subprocess starts (interpreter, card, first epoch) while
    # --profile runs here; nothing of either is timed
    log_dir = tempfile.mkdtemp(prefix="chip_smoke_rest_")
    sig_dir = os.path.join(log_dir, "sigterm")
    with open(TRAIN_CONFIG) as f:
        data = yaml.safe_load(f)
    data["trainer"]["log_dir"] = sig_dir
    sig_cfg = os.path.join(log_dir, "sigterm.yml")
    with open(sig_cfg, "w") as f:
        yaml.safe_dump(data, f)
    cmd = [sys.executable, "-m", "vq_vae_gan_diffusion_torch.train", "--config", sig_cfg,
           "--epochs", "50"]
    t0 = time.perf_counter()
    with open(os.path.join(log_dir, "sigterm.log"), "w") as logf:
        proc = subprocess.Popen(cmd, stdout=logf, stderr=subprocess.STDOUT)
        try:
            out = cli.run(["--config", TRAIN_CONFIG, "--debug", "--profile"],
                          overrides={"trainer.log_dir": log_dir})
            with open(os.path.join(out["run_dir"], "profile", "trace.json")) as f:
                events = json.load(f)["traceEvents"]
            kernels = [e for e in events if e.get("cat") == "kernel"]
            if not kernels:
                raise AssertionError("(ab) --profile's trace holds no CUDA kernel events")
            print(f"(ab) --profile: {len(events)} trace events, {len(kernels)} CUDA kernel "
                  f"events")
            del out
            rows = []
            while not rows and time.perf_counter() - t0 < 180 and proc.poll() is None:
                time.sleep(0.5)
                for path in glob.glob(os.path.join(sig_dir, "*", "*", "run_*",
                                                   "metrics.jsonl")):
                    with open(path) as f:
                        rows = [json.loads(line) for line in f if line.strip()]
            if not rows:
                raise AssertionError(f"(ab) no metrics row from the train CLI subprocess "
                                     f"(exit {proc.poll()})")
            proc.send_signal(signal.SIGTERM)
            rc = proc.wait(timeout=120)
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    run_dir = os.path.dirname(path)
    ckpts = sorted(glob.glob(os.path.join(run_dir, "ckpt", "step_*.pth")))
    with open(path) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    if rc != 143 or not ckpts:
        raise AssertionError(f"(ab) SIGTERM: exit {rc}, checkpoints {ckpts}")
    step = torch.load(ckpts[-1], weights_only=True)["step"]
    resumed = cli.run(["--config", sig_cfg, "--debug"],
                      overrides={"architecture.vqvae.resume_path": ckpts[-1]})
    if resumed["worker"].global_step != step + 2 or rows[-1]["step"] != step:
        raise AssertionError(f"(ab) SIGTERM checkpoint at step {step}, last metrics row "
                             f"{rows[-1]}, resumed to {resumed['worker'].global_step}")
    print(f"(ab) SIGTERM to the train CLI after its first metrics row: exit {rc} after "
          f"{time.perf_counter() - t0:.1f} s, the newest checkpoint at step {step} (of "
          f"{len(ckpts)} in all) with its metrics row; "
          f"resumed there, two --debug steps to {resumed['worker'].global_step}")
    del resumed

    cfg = load_config(TRAIN_CONFIG).replace_path("trainer.log_dir", log_dir)
    loader = DataLoader(SyntheticDataset(TRAIN_B * 12, 28, 1), TRAIN_B,
                        Preprocessor(28, list(cfg.dataset.mean)[:1], list(cfg.dataset.std)[:1],
                                     grayscale=True),
                        shuffle=True, drop_last=True, seed=0)
    for k in (1, 4):
        w = VQGANVQVAEWorker(cfg.replace_path("trainer.steps_per_dispatch", k),
                             os.path.join(log_dir, f"k{k}"), device="cuda")
        w.train(loader, 1)
        with open(os.path.join(log_dir, f"k{k}", "metrics.jsonl")) as f:
            epoch = [r for r in map(json.loads, f) if "epoch_time_s" in r][-1]
        print(f"(ab) steps_per_dispatch {k}: {epoch['steps']:.0f} steps at batch {TRAIN_B}, "
              f"{epoch['images_per_sec']:.1f} images/s; {card}")
        del w
    shutil.rmtree(log_dir)
    print(f"(ab) phase time {time.perf_counter() - t_phase:.1f} s; {card}")


def native_store_checks(root: str) -> None:
    """(ac) ``SampleStore.gather`` against the port's ``Preprocessor`` within
    1e-6 on (o)'s synthetic 28² x 1 store and on a 256² x 3 one; two seeded
    epochs, augmented and not, run twice: bit for bit the same."""
    import os

    import numpy as np

    from vq_vae_gan_diffusion_torch.data.datasets import SyntheticDataset
    from vq_vae_gan_diffusion_torch.data.native_loader import (NativeDataLoader, SampleStore,
                                                               build_sample_store)
    from vq_vae_gan_diffusion_torch.data.transforms import Preprocessor

    # (o)'s fallback: 64 x batch // 8 grayscale images of 28²; 256² x 3 at
    # training_config_small.yml's batch 20, with its mean and std
    for label, (n, size, ch, batch, mean, std) in {
            "28² x 1": (1600, 28, 1, TRAIN_B, (0.5,), (0.5,)),
            "256² x 3": (160, 256, 3, 20, (0.485, 0.456, 0.406), (0.229, 0.224, 0.225))}.items():
        ds = SyntheticDataset(n, size, ch, seed=0)
        t0 = time.perf_counter()
        path = build_sample_store(ds, os.path.join(root, f"s{size}.sdb"), img_size=size,
                                  grayscale=ch == 1)
        built = time.perf_counter() - t0
        store = SampleStore(path)
        idx = np.random.RandomState(1).permutation(n)[:64]
        got = store.gather(idx, mean=mean, std=std)
        prep = Preprocessor(size, mean, std, grayscale=ch == 1)
        err = float(np.abs(got - np.stack([prep(ds.get_image(int(i))) for i in idx])).max())
        if (store.n, store.h, store.w, store.c) != (n, size, size, ch) or not err <= 1e-6:
            raise AssertionError(f"(ac) {label} store {(store.n, store.h, store.w, store.c)}, "
                                 f"gather against Preprocessor {err:.3e}")
        store.close()
        for augment in (False, True):
            kw = dict(mean=mean, std=std, seed=7, **(NATIVE_AUGMENT if augment else {}))
            runs = []
            for _ in range(2):
                loader = NativeDataLoader(path, batch, **kw)
                t0 = time.perf_counter()
                runs.append([b for _ in range(2) for b in loader])
                sec = time.perf_counter() - t0
                loader.close()
            a, b = runs
            if len(a) != 2 * (n // batch) or not all(np.array_equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"(ac) {label} augment={augment}: two seeded runs differ")
            if np.array_equal(a[0], a[len(a) // 2]):
                raise AssertionError(f"(ac) {label}: two epochs gave the same first batch")
        print(f"(ac) {label} store of {n}: built in {built:.2f} s; gather of 64 against "
              f"Preprocessor max abs err {err:.3e} (tolerance 1e-6); two seeded epochs of "
              f"{n // batch} batches of {batch}, augmented and not, bit for bit equal in two "
              f"runs; the last augmented pass {sec:.3f} s "
              f"({2 * (n // batch) * batch / sec:.0f} images/s from {os.cpu_count()} cores)")


def phase_native_loader(card: str) -> dict:
    """(ac): the native sample-store loader on the card's machine. Its
    library built from csrc/sampledb.cpp at first use; the store checks;
    then the stage-1 train CLI on a copy of (o)'s config with
    ``dataset.use_native_loader: true``, batch 200, two epochs, beside (o)'s
    epochs on the Python loader (run here when (o) did not run). Fails if
    the library does not build or the run did not go through the native
    route (there is no fallback). Returns the JSON line's numbers."""
    import glob
    import os
    import tempfile

    import yaml

    from vq_vae_gan_diffusion_torch.data import native_loader
    from vq_vae_gan_diffusion_torch.ops import _build

    t0 = time.perf_counter()
    lib = native_loader._lib()
    built = time.perf_counter() - t0
    so = glob.glob(str(_build.BUILD_DIR / "libsampledb-*.so"))
    if not so or lib is None:
        raise AssertionError(f"(ac) libsampledb not built: {so}")
    print(f"(ac) csrc/sampledb.cpp built with {_build.host_compiler()} "
          f"{' '.join(_build.HOST_FLAGS)} in {built:.2f} s: {os.path.basename(so[0])}")
    root = tempfile.mkdtemp(prefix="chip_smoke_native_")
    native_store_checks(root)

    with open(TRAIN_CONFIG) as f:
        data = yaml.safe_load(f)
    data["dataset"].update(use_native_loader=True, cache_dir=os.path.join(root, "cache"))
    config = os.path.join(root, "training_config_mnist_native.yml")
    with open(config, "w") as f:
        yaml.safe_dump(data, f)
    if not PYTHON_LOADER_RUN:
        PYTHON_LOADER_RUN.update(cli_epochs("ac", TRAIN_CONFIG, root, TRAIN_EPOCHS, TRAIN_B))
    run = cli_epochs("ac", config, root, TRAIN_EPOCHS, TRAIN_B,
                     loader="the native store, gathered by C++ threads")
    with open(os.path.join(run["run_dir"], "info.log")) as f:
        routed = [line.strip() for line in f if "native loader:" in line]
    stores = glob.glob(os.path.join(root, "cache", "*.sdb"))
    if len(routed) != 2 or len(stores) != 2:
        raise AssertionError(f"(ac) the CLI did not load through the native route: {routed}, "
                             f"stores {stores}")
    print(f"(ac) {routed[0].split(' INFO ')[-1]}; stores {sorted(map(os.path.basename, stores))}")

    def split(r: dict) -> dict:
        warm = r["epochs"][1:]
        return {"warm_images_per_s": r["warm_images_per_s"],
                "loader_s": [e["loader_s"] for e in warm], "step_s": [e["step_s"] for e in warm],
                "artifact_s": [e["artifact_s"] for e in warm]}
    numbers = {"native": split(run), "python": split(PYTHON_LOADER_RUN), "batch": TRAIN_B,
               "card": card}
    print(json.dumps({"native_loader_cli": numbers}))
    shutil.rmtree(root)
    return numbers


def reference_forms() -> dict:
    """(ad) the reference's files drawn at full width from fixed seeds, with
    the modules they hold: stage 1's bare VQVAE and its discriminator
    (training_config_small.yml), the bare GPT (inference_config_small.yml),
    VQ_Official's ``{"diffusion", "optimizer", "scheduler", "model_ema"}``
    (training_config_vqofficial.yml; the AveragedModel EMA drawn apart from
    the online U-Net) and gaussiandiffusion3d's ``{"model", "model_ema"}``
    (training_config_pixel3d.yml)."""
    from vq_vae_gan_diffusion_torch.checkpoint import DISCRETE_SCHEDULE_BUFFERS
    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.models.discriminator import Discriminator
    from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import VQDiffusionComposite
    from vq_vae_gan_diffusion_torch.models.vq_transformer import VQTransformer
    from vq_vae_gan_diffusion_torch.models.vqvae import VQVAE
    from vq_vae_gan_diffusion_torch.train import GaussianDiffusion3DWorker

    def drawn(module, seed: int) -> dict:
        module.init_weights(torch.Generator().manual_seed(seed))
        gen = torch.Generator().manual_seed(seed + 1000)
        with torch.no_grad():                  # running statistics of no init, so a swap shows
            for name, buf in module.named_buffers():
                if name.endswith("running_mean"):
                    buf.copy_(0.1 * torch.randn(buf.shape, generator=gen))
                elif name.endswith("running_var"):
                    buf.copy_(0.5 + torch.rand(buf.shape, generator=gen))
        return {k: v.detach().clone() for k, v in module.state_dict().items()}

    def under(prefix: str, sd: dict) -> dict:
        return {prefix + k: v for k, v in sd.items()}

    def discrete(denoiser: dict, timesteps: int, seed: int) -> dict:
        gen = torch.Generator().manual_seed(seed)
        return {**under("model.", denoiser),
                **{k: torch.randn(timesteps, generator=gen) for k in DISCRETE_SCHEDULE_BUFFERS},
                "Lt_history": torch.rand(timesteps, generator=gen),
                "Lt_count": torch.randint(0, 40, (timesteps,), generator=gen).float()}

    stage1 = load_config(REF_CONFIGS["vqgan"])
    vqvae = drawn(VQVAE.from_config(stage1), 1)
    disc = drawn(Discriminator(int(stage1.dataset.img_channels[stage1.dataset.dataset_name])), 2)
    gpt = drawn(VQTransformer(load_config(REF_CONFIGS["vqvae_transformer"])).gpt, 3)
    vqo = VQDiffusionComposite(load_config(REF_CONFIGS["vqdiffusion"]))
    online, ema = drawn(vqo.unet, 4), drawn(vqo.unet, 5)
    diffusion = discrete(online, vqo.timesteps, 6)
    vqo_raw = {"diffusion": diffusion,
               "optimizer": {"state": {}, "param_groups": [{"lr": 1e-4, "params": [0]}]},
               "scheduler": {"last_epoch": 1000},
               "model_ema": {"n_averaged": torch.tensor(100),
                             **under("module.", discrete(ema, vqo.timesteps, 7))}}
    pixel = GaussianDiffusion3DWorker(load_config(REF_CONFIGS["gaussiandiffusion3d"]), "unused",
                                      device="cpu")
    p_online, p_ema = drawn(pixel.build_unet(), 8), drawn(pixel.build_unet(), 9)
    buffers = {"betas": torch.linspace(1e-4, 0.02, pixel.timesteps)}
    pixel_raw = {"model": {**under("model.", p_online), **buffers},
                 "model_ema": {"n_averaged": torch.tensor(100),
                               **under("module.", {**under("model.", p_ema), **buffers})}}
    return {
        "vqgan": dict(raw=vqvae, disc=disc, sources={"vqvae": vqvae, "disc": disc}),
        "vqvae_transformer": dict(raw=gpt, sources={"gpt": gpt}),
        "vqdiffusion": dict(raw=vqo_raw, sources={"unet": online, "ema": ema},
                            lt=(diffusion["Lt_history"], diffusion["Lt_count"])),
        "gaussiandiffusion3d": dict(raw=pixel_raw, sources={"unet": p_online, "ema": p_ema}),
    }


def phase_reference_checkpoints(card: str) -> dict:
    """(ad): the reference's files at full width through ``import_checkpoint``
    on the card; each written checkpoint resumed through its family's
    ``resume_path`` holds every source tensor (and VQ_Official's LtState
    its Lt buffers); VQ_Official served from its imported file through
    ``generate --ckpt``: a 20-step chain with exactly 780 K1, 80 K2 and 19
    B6 launches, every index that of the in-memory EMA U-Net with the same
    generator. Returns the launches."""
    import os
    import tempfile

    from vq_vae_gan_diffusion_torch import generate, import_checkpoint
    from vq_vae_gan_diffusion_torch.config import load_config
    from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import VQDiffusionComposite
    from vq_vae_gan_diffusion_torch.train import worker_class

    root = tempfile.mkdtemp(prefix="chip_smoke_import_")
    t0 = time.perf_counter()
    forms = reference_forms()
    print(f"(ad) reference files drawn at full width in {time.perf_counter() - t0:.1f} s")
    imported = {}
    for family, form in forms.items():
        pth = os.path.join(root, f"{family}.pth")
        torch.save(form["raw"], pth)
        argv = ["--config", REF_CONFIGS[family], "--pth", pth, "--out", os.path.join(root, family),
                "--step", "1000", "--device", "cuda", "--family", family]
        if "disc" in form:
            torch.save(form["disc"], os.path.join(root, "disc.pth"))
            argv += ["--disc-pth", os.path.join(root, "disc.pth")]
        # the priors over codes take the imported stage-1 VQVAE
        overrides = ({"architecture.vqvae.resume_path": imported["vqgan"]}
                     if family in ("vqvae_transformer", "vqdiffusion") else {})
        t0 = time.perf_counter()
        imported[family] = import_checkpoint.run(argv, overrides=overrides)["path"]
        sec = time.perf_counter() - t0
        key = "vqvae" if family == "vqgan" else family
        cfg = load_config(REF_CONFIGS[family]).replace_path("architecture.model_name", family)
        cfg = cfg.replace_path(f"architecture.{key}.resume_path", imported[family])
        for path, value in overrides.items():
            cfg = cfg.replace_path(path, value)
        worker = worker_class(family)(cfg, root, device="cuda")
        state = worker.init_state()
        n = 0
        for name, source in form["sources"].items():
            got = getattr(state, name).state_dict()
            if set(got) != set(source):
                raise AssertionError(f"(ad) {family} {name}: keys differ")
            for k, v in source.items():
                if not torch.equal(got[k].cpu(), v):
                    raise AssertionError(f"(ad) {family} {name}.{k} differs from its source")
                n += v.numel()
        if "lt" in form and not (torch.equal(state.lt.Lt_history.cpu(), form["lt"][0])
                                 and torch.equal(state.lt.Lt_count.cpu(), form["lt"][1])):
            raise AssertionError(f"(ad) {family}: LtState is not the file's Lt buffers")
        if worker.global_step != 1000:
            raise AssertionError(f"(ad) {family}: step {worker.global_step}")
        print(f"(ad) {family}: imported in {sec:.1f} s ({', '.join(form['sources'])}"
              f"{', lt' if 'lt' in form else ''}); resumed through architecture.{key}."
              f"resume_path: {n} elements equal to their source, step 1000")
        del worker, state
        torch.cuda.empty_cache()

    steps_path = "architecture.vqdiffusion.sampling_steps"
    argv = ["--config", REF_CONFIGS["vqdiffusion"], "--ckpt", imported["vqdiffusion"],
            "--n-samples", str(B), "--seed", "42", "--device", "cuda"]
    reset_counts()
    t0 = time.perf_counter()
    out = generate.run(argv, overrides={steps_path: VQO_STEPS,
                                        "architecture.vqvae.resume_path": imported["vqgan"]})
    sec = time.perf_counter() - t0
    launches = read_counts()
    want = {name: 0 for name in launches}
    want.update(shuffle_bottleneck=39 * VQO_STEPS, shuffle_downsample=4 * VQO_STEPS,
                discrete_posterior=VQO_STEPS - 1)
    if launches != want:
        raise AssertionError(f"(ad) launches {launches}, expected {want}")
    comp = VQDiffusionComposite(
        load_config(REF_CONFIGS["vqdiffusion"]).replace_path(steps_path, VQO_STEPS))
    comp.unet.load_state_dict(forms["vqdiffusion"]["sources"]["ema"], strict=True)
    comp = comp.to("cuda").eval()
    idx = comp.sample(B, generator=torch.Generator(device="cuda").manual_seed(42),
                      unet=comp.unet)
    got = out["indices"]
    if tuple(got.shape) != (B, comp.seq_len) or not torch.equal(got, idx):
        raise AssertionError(f"(ad) generate --ckpt indices {tuple(got.shape)}: "
                             f"{(got == idx).float().mean().item():.4f} equal to the "
                             "in-memory EMA U-Net's")
    if not torch.isfinite(out["images"]).all():
        raise AssertionError("(ad) non-finite images")
    print(f"(ad) generate --ckpt on the imported VQ_Official file: {VQO_STEPS}-step chain, "
          f"{launches['shuffle_bottleneck']} K1, {launches['shuffle_downsample']} K2, "
          f"{launches['discrete_posterior']} B6 launches; {sec:.1f} s; all {B} x "
          f"{comp.seq_len} indices equal to the in-memory EMA U-Net's with the same "
          f"generator; {card}")
    shutil.rmtree(root)
    return launches


def training_phases() -> dict:
    """The training phases and the Conv1d U-Net family's, each on its own, by
    label: each prints its JSON line."""
    return {"o": lambda card: print(json.dumps({"vqgan_train_step": phase_train(card)})),
            "p": lambda card: print(json.dumps({"gpt_train_step": phase_gpt_train(card)})),
            "q": lambda card: print(json.dumps({"vqd_train_step": phase_vqd_train(card)})),
            "r": lambda card: print(json.dumps({"pixel3d_train_step": phase_pixel_train(card)})),
            "s": lambda card: print(json.dumps({"vqofficial_train_step": phase_vqo_train(card)})),
            "t": phase_demo,
            "u": lambda card: print(json.dumps({"gaussian2d_train_step": phase_gaussian2d(card)})),
            "v": lambda card: print(json.dumps({"vqofficial1d_train_step":
                                                phase_vqofficial1d(card)})),
            "w": lambda card: print(json.dumps({"pixel2d_train_step": phase_pixel2d(card)})),
            "x": lambda card: print(json.dumps({"continuous_vq_train_step":
                                                phase_continuous(card)})),
            "y": lambda card: print(json.dumps({"vae_train_step": phase_vae(card)})),
            "z": lambda card: print(json.dumps({"pixel_ddpm_train_step":
                                                phase_pixel_ddpm(card)})),
            "aa": phase_bf16,
            "ab": phase_rest,
            "ac": phase_native_loader,
            "ad": phase_reference_checkpoints}


def timed(label: str, fn, *args):
    """``fn(*args)``, then a line with the phase's seconds on the host's clock."""
    t0 = time.perf_counter()
    out = fn(*args)
    print(f"chip_smoke: phase ({label}) {time.perf_counter() - t0:.1f} s")
    return out


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="smoke test of the port on one GPU")
    parser.add_argument("--only", default=None,
                        help="run (a), (b) and these training phases alone, comma-separated "
                             f"of {','.join(training_phases())}; prints no kernels line and no "
                             "result line")
    args = parser.parse_args(argv)
    t_script = time.perf_counter()
    card = phase_device()
    timed("b", phase_build)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.only:
        for label in args.only.split(","):
            timed(label, training_phases()[label], card)
        print(f"chip_smoke: phases {args.only} alone; no kernels line, no result line")
        return 0
    timing = timed("c", phase_kernel, card)
    launches = timed("d", phase_main)
    timed("e", phase_routes)
    units = timed("f", phase_units, card)
    timed("f, off-path shapes", phase_other_shapes)
    vqd_launches = timed("g", phase_vqdiffusion)
    timed("h", phase_vqd_routes)
    posterior = timed("i", phase_posterior, card)
    vqo_launches = timed("j", phase_vqofficial, card)
    tvq_launches = timed("k", phase_transformer, card)
    quant = timed("l", phase_quant_kernels, card)
    quant_launches = timed("m", phase_int8kv_path)
    timed("n", phase_int8kv_routes)
    for label, phase in training_phases().items():
        timed(label, phase, card)
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
    print(f"chip_smoke: all phases {time.perf_counter() - t_script:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

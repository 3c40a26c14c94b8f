"""Training entry point of the port (mirrors the root ``train.py`` for the
families the port trains).

Usage::

    python -m vq_vae_gan_diffusion_torch.train \\
        --config configs/training_config_mnist.yml [--seed 42] [--debug] \\
        [--epochs N] [--device cuda|cpu] [--fused-sampler on|off|pallas|packed] \\
        [--fused-posterior on|off|interpret|prng] [--bf16] [--profile]

Builds ``<trainer.log_dir>/<dataset>/<model>/run_<time>/`` with a copy of
the config and ``info.log``, loads the train and val splits (a synthetic
dataset where the data is not on disk, with a warning), trains the
config's worker and writes ``metrics.jsonl``, its images and one
checkpoint an epoch (``ckpt/step_<step>.pth``):

- ``vqvae`` / ``vqgan``: stage 1; the reconstruction GIF and
  ``val_recon_epoch<e>.jpg``; ``architecture.vqvae.resume_path`` resumes
  from such a checkpoint;
- ``vqvae_transformer`` / ``vqgan_transformer``: the GPT prior over the codes
  of the frozen VQVAE at ``architecture.vqvae.resume_path`` (a stage-1
  checkpoint); ``transformer_epoch<e>_<i>.jpg`` and ``samples_epoch<e>.jpg``;
- ``vqdiffusion``: the diffusion prior over those codes
  (``diffusion_type`` ``gaussiandiffusion3d`` or the discrete
  ``VQ_Official`` with its importance-sampling history), with its OneCycle
  schedule over ``num_epochs`` x the loader's batches and its EMA copy;
  ``recon_epoch<e>_<i>.jpg`` and the EMA's ``samples_epoch<e>.jpg``;
  ``diffusion_type`` ``gaussiandiffusion2d`` and VQ_Official's ``unet_dim:
  2`` train the Conv1d U-Net the same way;
- ``gaussiandiffusion2d``: the pixel-space diffusion of grayscale images,
  their rows the Conv1d U-Net's channels, Adam behind a global-norm clip of
  1.0 and an EMA at 0.9999 every 10 steps; the EMA's
  ``Generating_epoch<e>.jpg``;
- ``gaussiandiffusion3d``: the pixel-space DDPM on the images themselves
  (the ShuffleNet U-Net, mults (2, 4)), OneCycle and EMA as above; the
  EMA's ``samples_epoch<e>.jpg``;
- ``c_vqdiffusion`` / ``v_vqdiffusion``: the continuous priors over the
  frozen VQVAE's codes (indices / K, or codebook rows) with the Conv1d
  U-Net, Adam and an EMA at 0.999 every step; the EMA's
  ``samples_epoch<e>.jpg``;
- ``vae``: the plain VAE (MSE and the KL term, Adam), as
  ``configs/training_config_large.yml`` trains it; the reconstruction GIF,
  ``samples_epoch<e>.jpg`` and ``val_recon_epoch<e>.jpg``;
  ``architecture.vae.resume_path`` resumes from such a checkpoint.

A prior's training checkpoint at ``architecture.<model>.resume_path``
resumes it at its step. ``--bf16`` trains in bfloat16 as the root CLI's
flag does (flax's ``dtype=bfloat16`` with f32 parameters): each worker's
forward runs under bf16 autocast with the JAX package's f32 islands kept
f32, its sampling hooks sample in bf16 (the GPT's decode stack, the folded
U-Net's units and the discrete posterior in their bf16 builds where the
hook gives them bf16), and parameters, Adam's moments, EMA copies,
BatchNorm statistics and checkpoints stay f32. ``--profile`` writes a
``torch.profiler`` trace of the first epoch (CPU and CUDA activity) as the
Chrome trace ``<run_dir>/profile/trace.json``, then trains the other
epochs, as the root CLI does. ``trainer.steps_per_dispatch``, SIGTERM and
TensorBoard are the loop's (``train/base.py``). ``--fused-sampler`` and ``--fused-posterior``
write the keys the root ``train.py`` writes (``config.apply_fused_flags``,
shared with ``generate``). When the val split does not load, a warning and
no validation grid, as the root CLI. ``--debug`` trains one epoch of two batches of 2
images from the val split, as the root ``train.py`` does. It runs on CUDA
unless ``--device cpu``; with no GPU it raises.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Sequence

from ..config import (FUSED_POSTERIOR_CHOICES, FUSED_SAMPLER_CHOICES, apply_fused_flags,
                      load_config, validate)


def run(argv: Optional[Sequence[str]] = None,
        overrides: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """Parse ``argv`` and train; returns the worker, its run dir and the last
    metrics. ``overrides`` maps dotted config paths to values set after the
    command line's."""
    parser = argparse.ArgumentParser(description="PyTorch/CUDA trainer")
    parser.add_argument("--config", type=str, default="configs/training_config_small.yml")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--debug", action="store_true",
                        help="one epoch of two batches of 2 val-split images")
    parser.add_argument("--epochs", type=int, default=None, help="override trainer.num_epochs")
    parser.add_argument("--device", type=str, default=None, choices=["cuda", "cpu"],
                        help="default cuda; raises when no GPU is visible")
    parser.add_argument("--profile", action="store_true",
                        help="a torch.profiler trace of the first epoch under "
                             "<run_dir>/profile/trace.json")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (parameters, moments, EMA and checkpoints "
                             "stay f32)")
    parser.add_argument("--fused-sampler", type=str, default=None,
                        choices=FUSED_SAMPLER_CHOICES,
                        help="override the config's fused_sampler keys")
    parser.add_argument("--fused-posterior", type=str, default=None,
                        choices=FUSED_POSTERIOR_CHOICES,
                        help="override architecture.vqdiffusion.fused_posterior")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    validate(config)
    model_name = config.architecture.model_name
    dataset_name = config.dataset.dataset_name
    train_split = str(config.dataset.get("train_split", "train"))
    if args.debug:
        config = config.replace_path("trainer.num_epochs", 1)
        config = config.replace_path("trainer.num_workers", 1)
        config = config.replace_path(f"dataset.batch_size.{model_name}.{dataset_name}", 2)
        train_split = "val"
    config = apply_fused_flags(config, args.fused_sampler, args.fused_posterior)
    for path, value in (overrides or {}).items():
        config = config.replace_path(path, value)

    import torch

    from ..data import load_dataloader
    from ..utils import create_run_dir, resolve_device, setup_logging
    from . import ONECYCLE_MODELS, worker_class

    device = resolve_device(args.device)
    run_dir = create_run_dir(str(config.trainer.log_dir), dataset_name, model_name, args.config)
    logger = setup_logging(run_dir)
    logger.info("model=%s dataset=%s device=%s run_dir=%s", model_name, dataset_name,
                device, run_dir)
    train_loader, _ = load_dataloader(dataset_name, train_split, logger, config, seed=args.seed)
    try:
        val_loader, _ = load_dataloader(dataset_name, "val", logger, config, seed=args.seed)
    except Exception as e:  # the val split is optional, as in the root train.py
        logger.warning("no val split: %s", e)
        val_loader = None
    kwargs = dict(debug=args.debug, seed=args.seed, device=str(device),
                  dtype=torch.bfloat16 if args.bf16 else torch.float32)
    if model_name in ONECYCLE_MODELS:
        # OneCycle's total steps: epochs x batches an epoch, as the root train.py
        kwargs["num_iters_per_epoch"] = max(len(train_loader), 1)
    worker = worker_class(model_name)(config, run_dir, logger, **kwargs)
    epochs = args.epochs or int(config.trainer.num_epochs)
    if args.profile:
        from ..utils.profiling import profile_steps

        with profile_steps(os.path.join(run_dir, "profile")):
            metrics = worker.train(train_loader, 1, val_loader)
        epochs -= 1
    if epochs > 0:
        metrics = worker.train(train_loader, epochs, val_loader)
    logger.info("training done: %s", metrics)
    return {"worker": worker, "run_dir": run_dir, "metrics": metrics}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0

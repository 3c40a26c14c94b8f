"""Training entry point of the port (mirrors the root ``train.py`` for the
families the port trains).

Usage::

    python -m vq_vae_gan_diffusion_torch.train \\
        --config configs/training_config_mnist.yml [--seed 42] [--debug] \\
        [--epochs N] [--device cuda|cpu]

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
- ``vqdiffusion`` with ``diffusion_type: gaussiandiffusion3d``: the
  diffusion prior over those codes, with its OneCycle schedule over
  ``num_epochs`` x the loader's batches and its EMA copy;
  ``recon_epoch<e>_<i>.jpg`` and the EMA's ``samples_epoch<e>.jpg``.

A prior's training checkpoint at ``architecture.<model>.resume_path``
resumes it at its step. ``--debug`` trains one epoch of two batches of 2
images from the val split, as the root ``train.py`` does. It runs on CUDA
unless ``--device cpu``; with no GPU it raises. The other families raise
``NotImplementedError`` naming the ROADMAP item that ports them.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

from ..config import TRANSFORMER_MODELS, VQ_STAGE1_MODELS, load_config, validate

TRAINED = VQ_STAGE1_MODELS + TRANSFORMER_MODELS + ("vqdiffusion",)
# the ROADMAP item that ports each family's training
_LATER_SLICES = {
    "gaussiandiffusion3d": "A3, slice 4 (pixel-space gaussian3d worker)",
    "c_vqdiffusion": "slice 7 (other families)", "v_vqdiffusion": "slice 7 (other families)",
    "gaussiandiffusion2d": "slice 7 (other families)", "vae": "slice 7 (other families)",
}


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
    args = parser.parse_args(argv)

    config = load_config(args.config)
    validate(config)
    model_name = config.architecture.model_name
    dataset_name = config.dataset.dataset_name
    if model_name not in TRAINED:
        where = _LATER_SLICES.get(model_name, "a later slice")
        raise NotImplementedError(
            f"training {model_name!r} is not ported yet: see ROADMAP.md, {where}")
    if model_name == "vqdiffusion":
        diffusion_type = config.architecture.vqdiffusion.diffusion_type
        if diffusion_type != "gaussiandiffusion3d":
            raise NotImplementedError(
                f"training the {diffusion_type!r} prior is not ported yet: see ROADMAP.md, "
                "A4 (slice 5, discrete prior training)")
    train_split = str(config.dataset.get("train_split", "train"))
    if args.debug:
        config = config.replace_path("trainer.num_epochs", 1)
        config = config.replace_path("trainer.num_workers", 1)
        config = config.replace_path(f"dataset.batch_size.{model_name}.{dataset_name}", 2)
        train_split = "val"
    for path, value in (overrides or {}).items():
        config = config.replace_path(path, value)

    from ..data import load_dataloader
    from ..utils import create_run_dir, resolve_device, setup_logging
    from .vq_diffusion_worker import VQDiffusionWorker
    from .vq_transformer_worker import VQTransformerWorker
    from .vqgan_worker import VQGANVQVAEWorker

    device = resolve_device(args.device)
    run_dir = create_run_dir(str(config.trainer.log_dir), dataset_name, model_name, args.config)
    logger = setup_logging(run_dir)
    logger.info("model=%s dataset=%s device=%s run_dir=%s", model_name, dataset_name,
                device, run_dir)
    train_loader, _ = load_dataloader(dataset_name, train_split, logger, config, seed=args.seed)
    val_loader, _ = load_dataloader(dataset_name, "val", logger, config, seed=args.seed)
    kwargs = dict(debug=args.debug, seed=args.seed, device=str(device))
    if model_name in VQ_STAGE1_MODELS:
        worker_cls = VQGANVQVAEWorker
    elif model_name in TRANSFORMER_MODELS:
        worker_cls = VQTransformerWorker
    else:
        # OneCycle's total steps: epochs x batches an epoch, as the root train.py
        worker_cls = VQDiffusionWorker
        kwargs["num_iters_per_epoch"] = max(len(train_loader), 1)
    worker = worker_cls(config, run_dir, logger, **kwargs)
    epochs = args.epochs or int(config.trainer.num_epochs)
    metrics = worker.train(train_loader, epochs, val_loader)
    logger.info("training done: %s", metrics)
    return {"worker": worker, "run_dir": run_dir, "metrics": metrics}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0

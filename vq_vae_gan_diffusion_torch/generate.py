"""Generation entry point of the port (mirrors the root ``generate.py`` for the
stage-1 ``vqvae`` / ``vqgan`` models, the ``*_transformer`` models, the
``vqdiffusion`` priors and the pixel-space ``gaussiandiffusion3d`` DDPM).

Usage::

    python -m vq_vae_gan_diffusion_torch.generate \\
        [--config configs/training_config_small.yml] [--n-samples 16] [--seed 42] \\
        [--ckpt PATH] [--device cuda|cpu] [--fused-sampler on|off|pallas|packed] \\
        [--fused-posterior on|off|interpret|prng]

The default config is the root ``generate.py``'s; the GPT serving config
is ``configs/inference_config_small.yml``.

For ``vqvae`` / ``vqgan`` it writes ``val_recon_epoch0.jpg``: the first
``--n-samples`` images of the val split over the VQVAE's reconstructions
(the VQVAE from ``architecture.vqvae.resume_path`` or ``--ckpt``, a
training checkpoint of ``python -m vq_vae_gan_diffusion_torch.train``
included). Otherwise it samples ``--n-samples`` index grids with the config's prior (the GPT prior
for ``vqvae_transformer`` / ``vqgan_transformer``; for ``vqdiffusion`` the
gaussian3d diffusion prior, as in ``configs/inference_config_vqdiffusion.yml``,
the gaussian2d prior, as in ``configs/inference_config_gaussian2d.yml``,
or the discrete ``VQ_Official`` prior, as in
``configs/inference_config_vqofficial.yml`` and, on its Conv1d U-Net,
``configs/inference_config_vqofficial1d.yml``),
decodes them with the VQVAE and writes ``samples_epoch0.jpg`` under
``<trainer.log_dir>/<dataset>/<model>_generate/run_<time>/``. For
``gaussiandiffusion3d`` it samples ``--n-samples`` images with the
pixel-space DDPM's U-Net (its EMA copy in a training checkpoint) and writes
them, six to a row, as ``samples_epoch0.jpg``; for ``gaussiandiffusion2d``
it samples 4 images with the Conv1d U-Net (its EMA copy), as the JAX
worker, and writes ``Generating_epoch000.jpg``; ``c_vqdiffusion`` and
``v_vqdiffusion`` sample index grids with their EMA U-Net as the
``vqdiffusion`` priors do. For ``vae`` it decodes ``--n-samples`` draws
z ~ N(0, I) at ``latent_size`` (``samples_epoch0.jpg``) and writes the val
split's reconstructions (``val_recon_epoch0.jpg``), the VAE from
``--ckpt`` or ``architecture.vae.resume_path`` (the port's checkpoints, a
bare VAE ``state_dict`` or the export tool's ``{"vae_state_dict":
...}``). ``--ckpt`` loads a port
checkpoint (``torch.save({"vqvae": ..., "gpt" or "unet": ...})``, a
training checkpoint included) or a bare prior ``state_dict`` as
``tools/export_torch_checkpoint.py`` writes it from an Orbax checkpoint;
without one it tries
``architecture.<model>.resume_path``. The VQVAE comes from
``architecture.vqvae.resume_path`` (a bare VQVAE ``state_dict`` or a
bundle). A path where nothing exists warns and keeps the seeded fresh init;
a directory or a file of no known form raises (``checkpoint.py``).
``--fused-sampler`` overrides ``architecture.vqdiffusion.fused_sampler``
and, as the root ``generate.py`` does, ``trainer.{gaussiandiffusion3d,
vqdiffusion}.fused_sampler`` where the config has them: ``on`` runs the
CUDA kernels, ``off`` the unfused U-Net module; ``pallas`` and ``packed``
(the JAX package's TPU modes) are written as given and select the kernels
too (``config.apply_fused_flags``, shared with the train CLI).
``--fused-posterior`` overrides ``architecture.vqdiffusion.fused_posterior``
for the discrete prior: ``on`` runs each structured reverse step's posterior
and sample as one fused kernel reading Gumbel noise, ``prng`` as the fused
kernel that draws its own, ``off`` as plain ops (``interpret`` counts as
on; unset, it is on for CUDA). It runs on
CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict, Optional, Sequence

from .config import (FUSED_POSTERIOR_CHOICES, FUSED_SAMPLER_CHOICES, VQ_STAGE1_MODELS,
                     apply_fused_flags, load_config, validate)


def run(argv: Optional[Sequence[str]] = None,
        overrides: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """Parse ``argv``, generate, and return the worker's result (codes,
    images, the grid's path, phase seconds) with the run dir.
    ``overrides`` maps dotted config paths to values set after the command
    line's (e.g. ``{"architecture.vqdiffusion.sampling_steps": 20}``)."""
    parser = argparse.ArgumentParser(description="PyTorch/CUDA generation")
    parser.add_argument("--config", type=str, default="configs/training_config_small.yml")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--n-samples", type=int, default=16)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="port bundle or exported prior state_dict "
                             "(else architecture.<model>.resume_path)")
    parser.add_argument("--device", type=str, default=None, choices=["cuda", "cpu"],
                        help="default cuda; raises when no GPU is visible")
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
    config = apply_fused_flags(config, args.fused_sampler, args.fused_posterior)

    for path, value in (overrides or {}).items():
        config = config.replace_path(path, value)

    from .data import load_dataloader
    from .train import worker_class
    from .utils import create_run_dir, resolve_device, setup_logging

    device = resolve_device(args.device)
    dataset_name = config.dataset.dataset_name
    run_dir = create_run_dir(str(config.trainer.log_dir), dataset_name,
                             f"{model_name}_generate", args.config)
    logger = setup_logging(run_dir)
    if model_name in VQ_STAGE1_MODELS:
        return dict(_reconstruct(config, run_dir, logger, args, str(device)), run_dir=run_dir)
    worker = worker_class(model_name)(config, run_dir, logger, seed=args.seed,
                                      device=str(device))
    worker.init_state()
    ckpt = args.ckpt
    if ckpt is None:
        mkey = model_name if model_name in config.architecture else "vqvae"
        ckpt = config.architecture[mkey].get("resume_path")
    if ckpt:
        worker.load(str(ckpt))
    val_loader = None
    if model_name == "vae":
        # the val split's reconstructions, as the root generate.py writes them
        val_loader, _ = load_dataloader(dataset_name, "val", logger, config, seed=args.seed)
    result = worker.generate_images(val_loader, n_samples=args.n_samples, epoch=0)
    logger.info("artifacts written to %s", run_dir)
    return dict(result, run_dir=run_dir)


def _reconstruct(config, run_dir: str, logger, args, device: str) -> Dict[str, object]:
    """The stage-1 models' artifact: the val split's reconstruction grid by
    the VQVAE alone, seeded, then restored as the serving workers restore
    it, then from ``--ckpt``."""
    import torch

    from .checkpoint import restore
    from .data import load_dataloader
    from .models.vqvae import VQVAE
    from .train.base import ServingWorker
    from .train.vqgan_worker import write_reconstructions

    worker = ServingWorker(config, run_dir, logger, seed=args.seed, device=device)
    vqvae = VQVAE.from_config(config)
    vqvae.init_weights(torch.Generator().manual_seed(args.seed))
    worker._restore_vqvae(vqvae)
    if args.ckpt:
        restore(args.ckpt, {"vqvae": vqvae}, logger, "stage-1")
    val_loader, _ = load_dataloader(config.dataset.dataset_name, "val", logger, config,
                                    seed=args.seed)
    result = write_reconstructions(worker, vqvae.to(worker.device), val_loader,
                                   n_samples=args.n_samples, epoch=0)
    logger.info("artifacts written to %s", run_dir)
    return result


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Import a reference (torch) training file as a training checkpoint of the
port: the port's counterpart of ``tools/import_torch_checkpoint.py``.

Usage::

    python -m vq_vae_gan_diffusion_torch.import_checkpoint \\
        --config configs/training_config_mnist.yml \\
        --pth /path/to/vqvae_mnist.pth [--disc-pth /path/to/disc.pth] \\
        [--family vqgan] --out runs/imported_vqgan [--step 0] [--device cuda|cpu]

    # then: architecture.<model>.resume_path: runs/imported_vqgan/step_<step>.pth
    # (or generate --ckpt runs/imported_vqgan/step_<step>.pth)

The family is ``--family`` or the config's ``architecture.model_name``; the
config's worker is built with seeded weights and a fresh optimizer (the
reference's optimizer moments are not carried over, as in the JAX tool),
each part of the file (``checkpoint.reference_parts``) is loaded into its
module with ``load_state_dict(strict=True)``, the discrete prior's
``Lt_history`` and ``Lt_count`` go into its ``LtState``, ``--step`` seeds
the worker's ``global_step``, and the worker's own ``save()`` writes
``<out>/step_<step>.pth``. The module names are the reference's, so
nothing is converted: the import unwraps. ``--disc-pth`` is stage 1's
separate discriminator file (the ``vqgan`` family). Every ``vqdiffusion``
file is read as the discrete prior's ``{'diffusion', ...}`` with its Lt
buffers, as the JAX tool reads it: a gaussian3d or gaussian2d VQ prior's file,
which has none, is refused. ``c_vqdiffusion`` and ``v_vqdiffusion`` are
refused too: the reference saves no file for them.

For the priors over a VQVAE's codes only the prior is imported; the VQVAE
is the one the config's ``architecture.vqvae.resume_path`` gives (import
the reference's VQVAE file with a ``vqvae`` or ``vqgan`` config first). It
runs on CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import logging
import os
import pickle
import sys
from typing import Dict, Optional, Sequence

import torch

from .checkpoint import denoiser_kind, reference_parts
from .config import load_config, validate

log = logging.getLogger(__name__)


def _torch_load(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        # the reference's files may pickle more than tensors (its schedulers'
        # state), as the JAX tool allows
        log.warning("%s holds more than tensors; loading it with weights_only=False", path)
        return torch.load(path, map_location="cpu", weights_only=False)


def run(argv: Optional[Sequence[str]] = None,
        overrides: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """Parse ``argv`` and import; returns the worker and the checkpoint's
    path. ``overrides`` maps dotted config paths to values set after the
    config is read."""
    parser = argparse.ArgumentParser(description="import a reference torch checkpoint")
    parser.add_argument("--config", required=True, help="the port's YAML config")
    parser.add_argument("--pth", required=True, help="the reference's torch.save file")
    parser.add_argument("--disc-pth", default=None,
                        help="stage 1's separate discriminator file (vqgan family)")
    parser.add_argument("--family", default=None, help="override architecture.model_name")
    parser.add_argument("--out", required=True, help="directory of the written checkpoint")
    parser.add_argument("--step", type=int, default=0, help="global_step of the checkpoint")
    parser.add_argument("--device", type=str, default=None, choices=["cuda", "cpu"],
                        help="default cuda; raises when no GPU is visible")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    for path, value in (overrides or {}).items():
        config = config.replace_path(path, value)
    family = args.family or str(config.architecture.model_name)
    config = config.replace_path("architecture.model_name", family)
    validate(config)

    from .train import ONECYCLE_MODELS, worker_class
    from .utils import resolve_device, setup_logging

    parts = reference_parts(_torch_load(args.pth), family)
    if args.disc_pth:
        parts["disc"] = _torch_load(args.disc_pth)
    os.makedirs(args.out, exist_ok=True)
    logger = setup_logging(args.out)
    kwargs = dict(save_ckpt_dir=args.out, device=str(resolve_device(args.device)))
    if family in ONECYCLE_MODELS:
        kwargs["num_iters_per_epoch"] = 100        # the JAX tool's
    worker = worker_class(family)(config, args.out, logger, **kwargs)
    worker.state = state = worker.init_state()
    lt = parts.pop("lt", None)
    for name, sd in parts.items():
        module = getattr(state, name, None)
        if module is None:
            raise ValueError(f"the {family} worker has no {name} to load "
                             f"{args.disc_pth if name == 'disc' else args.pth} into")
        if name in ("unet", "ema") and denoiser_kind(sd) != denoiser_kind(module.state_dict()):
            raise ValueError(f"{args.pth} holds a {denoiser_kind(sd)} denoiser; the config's "
                             f"prior is a {denoiser_kind(module.state_dict())} U-Net")
        module.load_state_dict(sd, strict=True)
    if lt is not None and state.lt is not None:
        history, count = (x.to(state.lt.Lt_history) for x in lt)
        if history.shape != state.lt.Lt_history.shape or count.shape != history.shape:
            raise ValueError(f"Lt buffers {tuple(history.shape)}, {tuple(count.shape)} do not "
                             f"fit the prior's {tuple(state.lt.Lt_history.shape)} steps")
        state.lt = state.lt._replace(Lt_history=history, Lt_count=count)
    worker.global_step = args.step
    path = worker.save(epoch=0)
    print(f"imported {family} checkpoint ({', '.join(parts)}"
          f"{', lt' if lt is not None else ''}) -> {os.path.abspath(path)} (step {args.step})")
    return {"worker": worker, "path": path}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Generation entry point of the port (mirrors the root ``generate.py`` for the
``*_transformer`` models and the gaussian3d ``vqdiffusion`` prior).

Usage::

    python -m vq_vae_gan_diffusion_torch.generate \\
        --config configs/inference_config_small.yml [--n-samples 16] [--seed 42] \\
        [--ckpt PATH] [--device cuda|cpu] [--fused-sampler on|off] \\
        [--fused-posterior on|off|prng]

Samples ``--n-samples`` index grids with the config's prior (the GPT prior
for ``vqvae_transformer`` / ``vqgan_transformer``; for ``vqdiffusion`` the
gaussian3d diffusion prior, as in ``configs/inference_config_vqdiffusion.yml``,
or the discrete ``VQ_Official`` prior, as in
``configs/inference_config_vqofficial.yml``),
decodes them with the VQVAE and writes ``samples_epoch0.jpg`` under
``<trainer.log_dir>/<dataset>/<model>_generate/run_<time>/``. ``--ckpt`` loads
a port checkpoint (``torch.save({"vqvae": ..., "gpt" or "unet": ...})``);
without one it tries ``architecture.<model>.resume_path`` and, when that is
missing, warns and keeps the seeded fresh init. ``--fused-sampler``
overrides ``architecture.vqdiffusion.fused_sampler``: ``on`` runs the CUDA
kernels, ``off`` the unfused U-Net module (the config itself may also say
``pallas`` or ``packed``, which select the kernels too).
``--fused-posterior`` overrides ``architecture.vqdiffusion.fused_posterior``
for the discrete prior: ``on`` runs each structured reverse step's posterior
and sample as one fused kernel reading Gumbel noise, ``prng`` as the fused
kernel that draws its own, ``off`` as plain ops (the config may also say
``interpret``, which counts as on; unset, it is on for CUDA). It runs on
CUDA unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Dict, Optional, Sequence

from .config import TRANSFORMER_MODELS, load_config, validate

# the ROADMAP slice that ports each family's generation path
_LATER_SLICES = {
    "vqvae": "slice 2 (stage-1 VQGAN)", "vqgan": "slice 2 (stage-1 VQGAN)",
    "gaussiandiffusion3d": "slice 4 (pixel-space gaussian3d worker)",
    "c_vqdiffusion": "slice 7 (other families)",
    "v_vqdiffusion": "slice 7 (other families)",
    "gaussiandiffusion2d": "slice 7 (other families)",
    "vae": "slice 7 (other families)",
}


def run(argv: Optional[Sequence[str]] = None,
        overrides: Optional[Dict[str, object]] = None) -> Dict[str, object]:
    """Parse ``argv``, generate, and return the worker's result (codes,
    images, the grid's path, phase seconds) with the run dir.
    ``overrides`` maps dotted config paths to values set after the command
    line's (e.g. ``{"architecture.vqdiffusion.sampling_steps": 20}``)."""
    parser = argparse.ArgumentParser(description="PyTorch/CUDA generation")
    parser.add_argument("--config", type=str, default="configs/inference_config_small.yml")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--n-samples", type=int, default=16)
    parser.add_argument("--ckpt", type=str, default=None,
                        help="port checkpoint (else architecture.<model>.resume_path)")
    parser.add_argument("--device", type=str, default=None, choices=["cuda", "cpu"],
                        help="default cuda; raises when no GPU is visible")
    parser.add_argument("--fused-sampler", type=str, default=None,
                        choices=["on", "off"],
                        help="override architecture.vqdiffusion.fused_sampler")
    parser.add_argument("--fused-posterior", type=str, default=None,
                        choices=["on", "off", "prng"],
                        help="override architecture.vqdiffusion.fused_posterior")
    args = parser.parse_args(argv)

    config = load_config(args.config)
    validate(config)
    model_name = config.architecture.model_name
    if model_name not in TRANSFORMER_MODELS + ("vqdiffusion",):
        where = _LATER_SLICES.get(model_name, "a later slice")
        raise NotImplementedError(
            f"model_name {model_name!r} is not ported yet: see ROADMAP.md, {where}")
    if args.fused_sampler is not None and "vqdiffusion" in config.architecture:
        config = config.replace_path("architecture.vqdiffusion.fused_sampler",
                                     args.fused_sampler == "on")
    if args.fused_posterior is not None and "vqdiffusion" in config.architecture:
        config = config.replace_path("architecture.vqdiffusion.fused_posterior",
                                     {"on": True, "off": False}.get(args.fused_posterior,
                                                                    args.fused_posterior))

    for path, value in (overrides or {}).items():
        config = config.replace_path(path, value)

    from .train import VQDiffusionWorker, VQTransformerWorker
    from .utils import create_run_dir, resolve_device, setup_logging

    device = resolve_device(args.device)
    dataset_name = config.dataset.dataset_name
    run_dir = create_run_dir(str(config.trainer.log_dir), dataset_name,
                             f"{model_name}_generate", args.config)
    logger = setup_logging(run_dir)
    worker_cls = VQDiffusionWorker if model_name == "vqdiffusion" else VQTransformerWorker
    worker = worker_cls(config, run_dir, logger, seed=args.seed, device=str(device))
    worker.init_state()
    ckpt = args.ckpt
    if ckpt is None:
        mkey = model_name if model_name in config.architecture else "vqvae"
        ckpt = config.architecture[mkey].get("resume_path")
    if ckpt:
        if os.path.isfile(str(ckpt)):
            worker.load(str(ckpt))
        else:
            logger.warning("checkpoint %s not found; using fresh init", ckpt)
    result = worker.generate_images(None, n_samples=args.n_samples, epoch=0)
    logger.info("artifacts written to %s", run_dir)
    return dict(result, run_dir=run_dir)


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

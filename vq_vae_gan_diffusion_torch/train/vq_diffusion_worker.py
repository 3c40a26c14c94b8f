"""Stage-2 diffusion worker (PyTorch counterpart of the JAX
``train/vq_diffusion_worker.py``), serving side.

:meth:`init_state` draws the VQVAE and the U-Net from a generator seeded by
``seed`` (flax-style, as the JAX worker's init, which does not redraw
torch-style; the U-Net is the gaussian3d prior's, or the VQ_Official
prior's for the [1, K, N, 1] log-onehot input); :meth:`load` reads a port
checkpoint; :meth:`generate_images` samples indices through the config's
prior and decodes them (VQ_Official indices are not clamped, as in the JAX
worker: the mask class K-1 is also a codebook index). AdamW,
OneCycle, EMA and the training step come with the training half of the
slice, so the weights sampled with are the U-Net's own (the JAX worker
samples with its EMA copy, which equals them at init).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.vq_diffusion_composite import VQDiffusionComposite
from .base import ServingWorker


class VQDiffusionWorker(ServingWorker):
    composite: Optional[VQDiffusionComposite] = None

    def init_state(self) -> VQDiffusionComposite:
        """A fresh composite in eval mode on the worker's device. A stage-1
        port checkpoint at ``architecture.vqvae.resume_path`` replaces the
        VQVAE."""
        composite = VQDiffusionComposite(self.config, dtype=self.dtype)
        gen = torch.Generator().manual_seed(self.seed)
        composite.vqvae.init_weights(gen)
        composite.unet.init_weights(gen)
        self._restore_vqvae(composite.vqvae)
        self.composite = composite.to(self.device).eval().requires_grad_(False)
        n = sum(p.numel() for p in composite.unet.parameters())
        self.logger.info("diffusion prior params: %.1fM (%s)", n / 1e6,
                         composite.diffusion_type)
        return self.composite

    def load(self, path: str) -> None:
        """Load a port checkpoint: ``torch.save({"vqvae": ..., "unet": ...})``."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.composite.vqvae.load_state_dict(state["vqvae"], strict=True)
        self.composite.unet.load_state_dict(state["unet"], strict=True)
        self.logger.info("restored %s", path)

    @torch.no_grad()
    def generate_images(self, val_loader=None, n_samples: int = 16, epoch: int = 0
                        ) -> Dict[str, object]:
        """Sample ``n_samples`` x seq_len indices, decode them to NHWC images and
        write ``samples_epoch{epoch}.jpg``. ``val_loader`` is ignored, as in
        the JAX worker. Returns the indices, the images, the grid's path and
        the seconds of each phase (the device is synchronised between
        phases)."""
        out = self._sample_and_decode(
            lambda: self.composite.sample(n_samples, generator=self.generator),
            self.composite.z_to_image, epoch)
        out["indices"] = out.pop("codes")
        return out

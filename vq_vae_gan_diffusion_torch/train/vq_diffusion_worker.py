"""Stage-2 diffusion worker (PyTorch counterpart of the JAX
``train/vq_diffusion_worker.py``): a diffusion prior over the codes of a
frozen VQVAE, trained and served (gaussian3d, gaussian2d, VQ_Official on
the ShuffleNet or the Conv1d U-Net).

One step, as the JAX step computes it:

- :meth:`..models.vq_diffusion_composite.VQDiffusionComposite.loss`: the
  frozen VQVAE's indices, the prior's loss through the U-Net in train mode
  (its BatchNorm running statistics move);
- AdamW, OneCycle and the EMA of :mod:`.diffusion_trainer`, with the
  configured beta2.

The metrics are gaussian3d's ``noise_mse`` and ``indices_recon`` (where
the config computes it), or VQ_Official's ``vb_loss``, ``kl`` and
``decoder_nll``, and ``loss`` (gaussian2d's only metric). ``log_artifacts`` writes the inputs over
their reconstructions (``recon_epoch{e}_{i}.jpg``); checkpoints hold the
frozen VQVAE, the U-Net, its EMA copy, the optimizer, the step, the count
of updates and VQ_Official's importance-sampling history (``lt``).
``generate_images`` samples the EMA copy, as the JAX worker does, through
the BN-folded kernel route for a ShuffleNet U-Net unless ``fused_sampler``
is off (the Conv1d U-Net runs as its module), and writes the
filmstrip where ``return_all_timestamps`` is set. VQ_Official
indices are not clamped, as in the JAX worker: the mask class K-1 is also
a codebook index.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoint import read_training_checkpoint, restore
from ..config import Config
from ..models.vq_diffusion_composite import VQDiffusionComposite
from ..utils import make_grid, save_image, tracing
from .base import ServingWorker
from .diffusion_trainer import DiffusionState, DiffusionTrainer


class VQDiffusionWorker(DiffusionTrainer, ServingWorker):
    composite: Optional[VQDiffusionComposite] = None

    def __init__(self, config: Config, run_dir: str, logger=None, debug: bool = False,
                 seed: int = 0, save_ckpt_dir: Optional[str] = None,
                 device: Optional[str] = None, num_iters_per_epoch: int = 100,
                 dtype: torch.dtype = torch.float32):
        super().__init__(config, run_dir, logger, debug, seed, save_ckpt_dir, device, dtype)
        tr = config.trainer.vqdiffusion
        self._setup_schedule(tr, num_iters_per_epoch, float(tr.beta2))

    # -- state ---------------------------------------------------------------
    def init_state(self) -> DiffusionState:
        """A fresh composite on the worker's device: VQVAE and U-Net drawn
        from a generator seeded by ``seed`` (flax-style, as the JAX worker's
        init), the VQVAE frozen and replaced by the checkpoint at
        ``architecture.vqvae.resume_path`` (a stage-1 training checkpoint
        included), the EMA a copy of the U-Net, a fresh optimizer, and for
        VQ_Official an empty importance-sampling history; also set as the
        worker's state. A diffusion training checkpoint at
        ``architecture.vqdiffusion.resume_path`` replaces the whole state."""
        composite = VQDiffusionComposite(self.config, dtype=self.dtype)
        gen = torch.Generator().manual_seed(self.seed)
        composite.vqvae.init_weights(gen)
        composite.unet.init_weights(gen)
        self._restore_vqvae(composite.vqvae)
        self.composite = composite.to(self.device)
        composite.vqvae.eval().requires_grad_(False)
        lt = composite.init_lt_state() if composite.diffusion_type == "VQ_Official" else None
        state = self._new_state(composite.unet, lt)
        n = sum(p.numel() for p in composite.unet.parameters())
        self.logger.info("diffusion prior params: %.1fM (%s)", n / 1e6,
                         composite.diffusion_type)
        resume = self.config.architecture.vqdiffusion.get("resume_path") \
            if "vqdiffusion" in self.config.architecture else None
        self.state = state
        tree = read_training_checkpoint(str(resume), "unet") if resume else None
        if tree is not None:
            self.load_checkpoint_tree(tree)
            self.logger.info("diffusion state resumed from %s at step %d", resume, state.step)
        return state

    def load(self, path: str) -> None:
        """Load a diffusion training checkpoint of this worker whole, or a port
        bundle (``torch.save({"vqvae": ..., "unet": ...})``) or a bare
        U-Net-denoiser (ShuffleNet or Conv1d) or VQVAE ``state_dict`` as
        ``tools/export_torch_checkpoint.py`` writes it (``--ema`` gives the
        weights the JAX worker samples with) into the U-Net and its EMA
        copy alike; a path where nothing exists only warns, any other
        unreadable path raises."""
        tree = read_training_checkpoint(path, "unet")
        if tree is not None:
            self.load_checkpoint_tree(tree)
            self.logger.info("prior: restored the training state of %s", path)
        elif restore(path, {"vqvae": self.composite.vqvae, "unet": self.composite.unet},
                     self.logger, "prior"):
            self.state.ema.load_state_dict(self.composite.unet.state_dict())

    def checkpoint_tree(self) -> Dict[str, Any]:
        return {"state": {"vqvae": self.composite.vqvae.state_dict(), **self.state.state_dict()},
                "step": self.global_step}

    def load_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        self.composite.vqvae.load_state_dict(tree["state"]["vqvae"], strict=True)
        super().load_checkpoint_tree(tree)

    # -- the step ------------------------------------------------------------
    def train_step(self, state: DiffusionState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        """One step on ``batch`` [B, H, W, C] -> (state, metrics). ``t`` and
        ``noise`` (gaussian3d: the Gaussian noise; VQ_Official: the Gumbel
        noise of q(x_t | x_0)) come from ``generator`` unless given."""
        with tracing.span("train.step"):
            imgs = batch if isinstance(batch, torch.Tensor) else self.batch_to_device(batch)
            with tracing.span("train.forward"), self.autocast():
                loss, metrics, state.lt = self.composite.loss(imgs, generator, t=t,
                                                              noise=noise, lt=state.lt)
            self._update(state, loss)
            return state, {k: v.detach() for k, v in dict(metrics, loss=loss).items()}

    # -- artifacts -------------------------------------------------------------
    def log_artifacts(self, batch: torch.Tensor, epoch: int, index: int) -> None:
        """The first 4 images of ``batch`` over their reconstructions, as
        ``recon_epoch{epoch}_{index}.jpg``."""
        logs = self.composite.log_images(batch)
        rows = [self.to_uint8(logs[k]) for k in ("input", "rec")]
        save_image(make_grid(np.concatenate(rows, axis=0), nrow=4),
                   os.path.join(self.run_dir, f"recon_epoch{epoch}_{index}.jpg"))

    @torch.no_grad()
    def generate_images(self, val_loader=None, n_samples: int = 16, epoch: int = 0
                        ) -> Dict[str, object]:
        """Sample ``n_samples`` x seq_len indices with the EMA copy, decode them
        to NHWC images and write ``samples_epoch{epoch}.jpg``; under
        ``return_all_timestamps`` also ``filmstrip_epoch{epoch}.jpg``, the
        first sample's image at each frame. ``val_loader`` is ignored, as in
        the JAX worker. Returns the indices (the filmstrip's [B, F, N] under
        ``filmstrip``), the images, the grid's path and the seconds of each
        phase (the device is synchronised between phases)."""
        frames = []

        def sample() -> torch.Tensor:
            idx = self.composite.sample(n_samples, generator=self.generator,
                                        unet=self.state.ema)
            if idx.dim() == 3:
                frames.append(idx)
                idx = idx[:, -1]
            return idx

        out = self._sample_and_decode(sample, self.composite.z_to_image, epoch)
        out["indices"] = out.pop("codes")
        if frames:
            film = frames[0]
            images = [self.to_uint8(self.composite.z_to_image(film[:, i])[:1])[0]
                      for i in range(film.shape[1])]
            path = os.path.join(self.run_dir, f"filmstrip_epoch{epoch}.jpg")
            save_image(make_grid(np.stack(images), nrow=8), path)
            out["filmstrip"] = film
        return out

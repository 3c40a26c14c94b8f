"""Stage-2 diffusion worker (PyTorch counterpart of the JAX
``train/vq_diffusion_worker.py``): a diffusion prior over the codes of a
frozen VQVAE, trained (gaussian3d) and served (gaussian3d, VQ_Official).

One step, as the JAX step computes it:

- :meth:`..models.vq_diffusion_composite.VQDiffusionComposite.loss`: the
  frozen VQVAE's indices, the prior's loss through the U-Net in train mode
  (its BatchNorm running statistics move);
- AdamW (weight decay 0.01 on every parameter, eps 1e-8, the configured
  beta2) with torch's OneCycle lr and beta1 (:mod:`..utils.schedules`) over
  ``max(num_epochs * num_iters_per_epoch, 10)`` updates, set before each
  update, through :func:`.base.maybe_accumulate`;
- on steps whose count before the step is a multiple of
  ``model_ema_steps``: the EMA copy moves toward the updated parameters
  with ``decay = 1 - min(1, (1 - model_ema_decay) * batch * model_ema_steps
  / num_epochs)``, and its BatchNorm statistics are copied from the live
  ones.

The metrics are ``noise_mse``, ``indices_recon`` (where the config computes
it) and ``loss``. ``log_artifacts`` writes the inputs over their
reconstructions (``recon_epoch{e}_{i}.jpg``); checkpoints hold the frozen
VQVAE, the U-Net, its EMA copy, the optimizer, the step and the count of
updates. ``generate_images`` samples the EMA copy, as the JAX worker does,
through the BN-folded kernel route unless ``fused_sampler`` is off, and
writes the filmstrip where ``return_all_timestamps`` is set. VQ_Official
indices are not clamped, as in the JAX worker: the mask class K-1 is also
a codebook index.
"""

from __future__ import annotations

import copy
import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoint import read_training_checkpoint, restore
from ..config import Config, resolve_batch_size
from ..models.unet_shuffle import ShuffleUNet
from ..models.vq_diffusion_composite import VQDiffusionComposite
from ..utils import make_grid, save_image
from ..utils.ema import ema_update
from ..utils.schedules import torch_onecycle_schedules
from .base import MultiSteps, ServingWorker, TrainingWorker, maybe_accumulate

WEIGHT_DECAY = 0.01


@dataclasses.dataclass
class VQDiffusionState:
    """The trained U-Net, its EMA copy (parameters and BatchNorm
    statistics), the optimizer, the step count and the count of optimizer
    updates, which indexes the OneCycle schedule."""

    unet: ShuffleUNet
    ema: ShuffleUNet
    opt: Any
    step: int = 0
    updates: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"unet": self.unet.state_dict(), "ema": self.ema.state_dict(),
                "opt": self.opt.state_dict(), "step": self.step, "updates": self.updates}

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        self.unet.load_state_dict(tree["unet"], strict=True)
        self.ema.load_state_dict(tree["ema"], strict=True)
        self.opt.load_state_dict(tree["opt"])
        self.step, self.updates = int(tree["step"]), int(tree["updates"])


class VQDiffusionWorker(TrainingWorker, ServingWorker):
    composite: Optional[VQDiffusionComposite] = None

    def __init__(self, config: Config, run_dir: str, logger=None, debug: bool = False,
                 seed: int = 0, save_ckpt_dir: Optional[str] = None,
                 device: Optional[str] = None, num_iters_per_epoch: int = 100):
        super().__init__(config, run_dir, logger, debug, seed, save_ckpt_dir, device)
        tr = config.trainer.vqdiffusion
        self.trainer_cfg = tr
        self.model_ema_steps = int(tr.get("model_ema_steps", 10))
        num_epochs = int(config.trainer.num_epochs)
        alpha = min(1.0, (1.0 - float(tr.get("model_ema_decay", 0.995)))
                    * resolve_batch_size(config) * self.model_ema_steps / max(num_epochs, 1))
        self.ema_decay = 1.0 - alpha
        self.total_steps = max(num_epochs * num_iters_per_epoch, 10)
        # torch's OneCycleLR, as the reference uses it: its default
        # cycle_momentum=True replaces the configured beta1 (0.65 in the
        # shipped config) with its 0.95 <-> 0.85 cycle from the first step,
        # so trainer.vqdiffusion.beta1 is deliberately unused, exactly like
        # the reference and the JAX worker; beta2 is kept
        self.lr_fn, self.b1_fn = torch_onecycle_schedules(self.total_steps,
                                                          float(tr.learning_rate))
        self.beta2 = float(tr.beta2)

    # -- state ---------------------------------------------------------------
    def init_state(self) -> VQDiffusionState:
        """A fresh composite on the worker's device: VQVAE and U-Net drawn
        from a generator seeded by ``seed`` (flax-style, as the JAX worker's
        init), the VQVAE frozen and replaced by the checkpoint at
        ``architecture.vqvae.resume_path`` (a stage-1 training checkpoint
        included), the EMA a copy of the U-Net, a fresh optimizer; also set
        as the worker's state. A diffusion training checkpoint at
        ``architecture.vqdiffusion.resume_path`` replaces the whole state."""
        composite = VQDiffusionComposite(self.config, dtype=self.dtype)
        gen = torch.Generator().manual_seed(self.seed)
        composite.vqvae.init_weights(gen)
        composite.unet.init_weights(gen)
        self._restore_vqvae(composite.vqvae)
        self.composite = composite.to(self.device)
        composite.vqvae.eval().requires_grad_(False)
        ema = copy.deepcopy(composite.unet).eval().requires_grad_(False)
        opt = torch.optim.AdamW(composite.unet.parameters(), lr=self.lr_fn(0),
                                betas=(self.b1_fn(0), self.beta2), eps=1e-8,
                                weight_decay=WEIGHT_DECAY)
        state = VQDiffusionState(composite.unet, ema, maybe_accumulate(opt, self.trainer_cfg))
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
        ShuffleNet-denoiser or VQVAE ``state_dict`` as
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
        self.state.load_state_dict(tree["state"])
        self.global_step = int(tree["step"])

    # -- the step ------------------------------------------------------------
    def _inner(self, opt) -> torch.optim.Optimizer:
        return opt.opt if isinstance(opt, MultiSteps) else opt

    def train_step(self, state: VQDiffusionState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        """One step on ``batch`` [B, H, W, C] -> (state, metrics). ``t`` and
        ``noise`` come from ``generator`` unless given."""
        imgs = batch if isinstance(batch, torch.Tensor) else self.batch_to_device(batch)
        loss, metrics = self.composite.loss(imgs, generator, t=t, noise=noise)
        for group in self._inner(state.opt).param_groups:
            group["lr"] = self.lr_fn(state.updates)
            group["betas"] = (self.b1_fn(state.updates), group["betas"][1])
        state.opt.zero_grad()
        loss.backward()
        state.opt.step()
        if getattr(state.opt, "mini_step", 0) == 0:
            state.updates += 1
        if state.step % self.model_ema_steps == 0:
            ema_update(state.ema, state.unet, self.ema_decay)
            with torch.no_grad():
                for e, b in zip(state.ema.buffers(), state.unet.buffers()):
                    e.copy_(b)
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

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

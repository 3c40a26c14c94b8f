"""Worker of the continuous VQ-diffusion priors (PyTorch counterpart of the
JAX ``train/continuous_vq_worker.py``): ``c_vqdiffusion`` (the scalar
baseline) and ``v_vqdiffusion`` (codebook vectors) over a frozen VQVAE
(``models/continuous_vq.py``).

One step, as the JAX step computes it: the prior's MSE loss through the
Conv1d U-Net, Adam (lr, beta1, beta2 from ``trainer.<model>`` or else
``trainer.vqdiffusion``, defaulting to 1e-4, 0.9 and 0.99; eps 1e-8), and
the EMA copy moved with decay 0.999 on every step. The frozen VQVAE comes
from ``architecture.vqvae.resume_path``. The metric is ``loss``; the
training loop writes no per-step artifact, as in JAX. ``generate_images``
samples ``n_samples`` index grids with the EMA copy, decodes them and
writes ``samples_epoch{e}.jpg`` four to a row. Checkpoints hold the
frozen VQVAE, the U-Net, its EMA copy, the optimizer and the step; a
training checkpoint at ``architecture.<model>.resume_path`` (or
``architecture.vqdiffusion.resume_path`` where the config has no section
for the model) resumes it.
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional

import torch

from ..checkpoint import read_training_checkpoint, restore
from ..config import Config
from ..models.continuous_vq import C_VQDiffusion, V_VQDiffusion
from .base import ServingWorker, maybe_accumulate
from .diffusion_trainer import DiffusionState, DiffusionTrainer

EMA_DECAY = 0.999


class ContinuousVQDiffusionWorker(DiffusionTrainer, ServingWorker):
    def __init__(self, config: Config, run_dir: str, logger=None, debug: bool = False,
                 seed: int = 0, save_ckpt_dir: Optional[str] = None,
                 device: Optional[str] = None, dtype: torch.dtype = torch.float32):
        super().__init__(config, run_dir, logger, debug, seed, save_ckpt_dir, device, dtype)
        self.model_name = str(config.architecture.model_name)
        self.trainer_cfg = config.trainer.get(self.model_name, config.trainer.get("vqdiffusion"))
        self.composite: Optional[C_VQDiffusion] = None

    # -- state ---------------------------------------------------------------
    def init_state(self) -> DiffusionState:
        """A fresh prior on the worker's device: VQVAE and U-Net drawn
        flax-style from a generator seeded by ``seed``, the VQVAE frozen and
        replaced by the checkpoint at ``architecture.vqvae.resume_path``, the
        EMA a copy of the U-Net, a fresh Adam; also set as the worker's
        state. A training checkpoint at the prior's ``resume_path`` replaces
        the whole state."""
        cls = V_VQDiffusion if self.model_name.startswith("v_") else C_VQDiffusion
        composite = cls(self.config)
        gen = torch.Generator().manual_seed(self.seed)
        composite.vqvae.init_weights(gen)
        composite.unet.init_weights(gen)
        self._restore_vqvae(composite.vqvae)
        self.composite = composite.to(self.device)
        composite.vqvae.eval().requires_grad_(False)
        tr = self.trainer_cfg
        opt = torch.optim.Adam(composite.unet.parameters(),
                               lr=float(tr.get("learning_rate", 1e-4)),
                               betas=(float(tr.get("beta1", 0.9)), float(tr.get("beta2", 0.99))),
                               eps=1e-8)
        unet = composite.unet
        self.state = DiffusionState(unet, copy.deepcopy(unet).eval().requires_grad_(False),
                                    maybe_accumulate(opt, tr))
        n = sum(p.numel() for p in unet.parameters())
        self.logger.info("%s U-Net params: %.1fM", self.model_name, n / 1e6)
        resume = composite.diffusion_config(self.config).get("resume_path")
        tree = read_training_checkpoint(str(resume), "unet") if resume else None
        if tree is not None:
            self.load_checkpoint_tree(tree)
            self.logger.info("state resumed from %s at step %d", resume, self.state.step)
        return self.state

    def load(self, path: str) -> None:
        """Load a training checkpoint of this worker whole, or a port bundle
        (``{"vqvae": ..., "unet": ...}``) or a bare VQVAE or U-Net
        ``state_dict`` into the VQVAE and the U-Net and its EMA copy alike; a
        path where nothing exists only warns, any other unreadable path
        raises."""
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
        ``noise`` come from ``generator`` unless given."""
        imgs = batch if isinstance(batch, torch.Tensor) else self.batch_to_device(batch)
        with self.autocast():
            loss = self.composite.loss(imgs, generator, t=t, noise=noise)
        self._step(state, loss, EMA_DECAY, 1)
        return state, {"loss": loss.detach()}

    # -- artifacts -------------------------------------------------------------
    @torch.no_grad()
    def generate_images(self, val_loader=None, n_samples: int = 16, epoch: int = 0
                        ) -> Dict[str, object]:
        """Sample ``n_samples`` x seq_length indices with the EMA copy, decode
        them and write ``samples_epoch{epoch}.jpg``; ``val_loader`` is
        ignored, as in the JAX worker. Returns the indices, the images, the
        grid's path and the seconds of each phase."""
        out = self._sample_and_decode(
            lambda: self.composite.sample(n_samples, self.generator, self.state.ema,
                                          dtype=self.dtype),
            self.composite.z_to_image, epoch)
        out["indices"] = out.pop("codes")
        return out

"""VAE worker (PyTorch counterpart of the JAX ``train/vae_worker.py``).

One step, as the JAX step computes it:

- the VAE forward on the batch (in eval mode: the JAX step applies no
  dropout) with ε from the step's generator, or given (``eps``);
- ``recon_loss = mean((x̂ - x)²)``;
- ``kld = -½ Σ(1 + logσ² - µ² - exp logσ²) / x.numel()``, in float32 at
  least: the sum over the latent divided by the number of the image's
  elements, as the reference normalises it;
- ``vae_loss = rec_loss_factor · recon_loss + kld_weight · kld`` and one
  Adam step (β from ``trainer.vae``, else ``trainer.vqvae``; eps 1e-8;
  ``gradient_accumulate_every`` through :func:`.base.maybe_accumulate`).

The metrics are the JAX step's: ``recon_loss``, ``kld``, ``vae_loss``, as
0-d tensors on the worker's device. Sampling draws z ~ N(0, I) at
``latent_size`` and decodes it. The reconstructions of the artifacts draw
ε from a generator seeded 0 at each call, where the JAX worker uses
``PRNGKey(0)``: the same noise at every call, another stream.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..checkpoint import read_training_checkpoint, restore
from ..config import Config
from ..models.vae import VAE
from ..utils import make_grid, save_gif, save_image
from .base import TrainingWorker, maybe_accumulate


@dataclasses.dataclass
class VAEState:
    """The VAE, its optimizer and the step count."""

    vae: VAE
    opt: Any
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"vae": self.vae.state_dict(), "opt": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        self.vae.load_state_dict(tree["vae"], strict=True)
        self.opt.load_state_dict(tree["opt"])
        self.step = int(tree["step"])


class VAEWorker(TrainingWorker):
    """The JAX ``VAEWorker``: trains and serves ``model_name: vae``."""

    def __init__(self, config: Config, run_dir: str, logger=None, debug: bool = False,
                 seed: int = 0, save_ckpt_dir: Optional[str] = None,
                 device: Optional[str] = None, dtype: torch.dtype = torch.float32):
        super().__init__(config, run_dir, logger, debug, seed, save_ckpt_dir, device, dtype)
        self.trainer_cfg = config.trainer.get("vae", config.trainer.get("vqvae"))
        tr = self.trainer_cfg
        self.lr = float(tr.get("learning_rate", 2.25e-5))
        self.betas = (float(tr.get("beta1", 0.5)), float(tr.get("beta2", 0.9)))
        self.kld_weight = float(tr.get("kld_weight", 0.1))
        self.rec_loss_factor = float(tr.get("rec_loss_factor", 1.0))
        self.gif_frames: list = []

    # -- state ---------------------------------------------------------------
    def init_state(self) -> VAEState:
        """Seeded fresh weights (``torch.Generator(seed)``) and a fresh Adam;
        a training checkpoint at ``architecture.vae.resume_path`` replaces
        both, a bare VAE ``state_dict`` there the VAE alone."""
        vae = VAE.from_config(self.config)
        vae.init_weights(torch.Generator().manual_seed(self.seed))
        vae = vae.to(self.device).eval()
        opt = maybe_accumulate(torch.optim.Adam(vae.parameters(), lr=self.lr, betas=self.betas,
                                                eps=1e-8), self.trainer_cfg)
        self.state = VAEState(vae, opt)
        n = sum(p.numel() for p in vae.parameters())
        self.logger.info("VAE params: %.1fM", n / 1e6)
        arch = self.config.architecture
        resume = arch.get("vae", arch.get("vqvae")).get("resume_path")
        if resume:
            tree = read_training_checkpoint(str(resume), "vae")
            if tree is not None:
                self.load_checkpoint_tree(tree)
                self.logger.info("VAE state resumed from %s at step %d", resume,
                                 self.state.step)
            else:
                self.load(str(resume))
        return self.state

    def load(self, path: str) -> None:
        """The VAE of the checkpoint at ``path`` (a training checkpoint, a
        bundle, a bare ``state_dict`` or the export tool's
        ``{"vae_state_dict": ...}``); a path where nothing exists warns."""
        restore(path, {"vae": self.state.vae}, self.logger, "vae")

    def checkpoint_tree(self) -> Dict[str, Any]:
        return {"state": self.state.state_dict(), "step": self.global_step}

    def load_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        self.state.load_state_dict(tree["state"])
        self.global_step = int(tree["step"])

    # -- the step ------------------------------------------------------------
    def loss(self, vae: VAE, imgs: torch.Tensor, eps: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None):
        """(vae_loss, metrics) of ``vae`` on ``imgs`` [B, H, W, C]."""
        decoded, mu, logvar = vae(imgs, eps, generator)
        recon = torch.mean((decoded - imgs) ** 2)
        dtype = torch.promote_types(mu.dtype, torch.float32)
        mu, logvar = mu.to(dtype), logvar.to(dtype)
        kld = -0.5 * torch.sum(1 + logvar - mu ** 2 - torch.exp(logvar)) / imgs.numel()
        loss = self.rec_loss_factor * recon + self.kld_weight * kld
        return loss, {"recon_loss": recon, "kld": kld, "vae_loss": loss}

    def train_step(self, state: VAEState, batch, generator: Optional[torch.Generator] = None,
                   *, eps: Optional[torch.Tensor] = None):
        """One step on ``batch`` [B, H, W, C] (normalised, as the loader gives
        it) -> (state, metrics); ε from ``generator`` unless ``eps`` is given.
        The state's VAE and optimizer move in place."""
        imgs = self.batch_to_device(batch) if not isinstance(batch, torch.Tensor) else batch
        with self.autocast():
            loss, metrics = self.loss(state.vae.eval(), imgs, eps, generator)
        state.opt.zero_grad()
        loss.backward()
        self.reduce_gradients(state.vae)
        state.opt.step()
        state.step += 1
        return state, {k: v.detach() for k, v in metrics.items()}

    # -- artifacts -------------------------------------------------------------
    @torch.no_grad()
    def reconstruct(self, imgs) -> torch.Tensor:
        """The VAE's reconstruction of ``imgs`` [B, H, W, C], ε from a
        generator seeded 0."""
        imgs = torch.as_tensor(np.asarray(imgs, np.float32)).to(self.device) \
            if not isinstance(imgs, torch.Tensor) else imgs
        gen = torch.Generator(device=self.device).manual_seed(0)
        return self.state.vae.eval()(imgs, generator=gen)[0]

    def log_artifacts(self, batch: torch.Tensor, epoch: int, index: int) -> None:
        """The first 8 images of ``batch`` over their reconstructions, added as
        a frame to ``reconstruction.gif``."""
        imgs = batch[:8]
        both = np.concatenate([self.to_uint8(imgs), self.to_uint8(self.reconstruct(imgs))])
        self.gif_frames.append(make_grid(both, nrow=8))
        save_gif(self.gif_frames, os.path.join(self.run_dir, "reconstruction.gif"))

    @torch.no_grad()
    def sample(self, n_samples: int = 16) -> torch.Tensor:
        """z ~ N(0, I) [n, latent_size, latent_size, latent_channels] from the
        worker's generator, decoded: [n, H, W, C]."""
        vae = self.state.vae.eval()
        g = vae.latent_size
        z = torch.randn(n_samples, g, g, vae.latent_channels, generator=self.generator,
                        device=self.device)
        with self.autocast():
            return vae.decode(z)

    def generate_images(self, val_loader=None, n_samples: int = 16,
                        epoch: int = 0) -> Dict[str, object]:
        """``samples_epoch{epoch}.jpg`` (four to a row); with ``val_loader``
        also ``val_recon_epoch{epoch}.jpg``, the first ``n_samples`` images
        of its first batch over their reconstructions. Returns the samples,
        the grids' paths and the seconds of sampling and reconstruction."""
        self._sync()
        t0 = time.perf_counter()
        samples = self.sample(n_samples)
        self._sync()
        t1 = time.perf_counter()
        path = os.path.join(self.run_dir, f"samples_epoch{epoch}.jpg")
        save_image(make_grid(self.to_uint8(samples), nrow=4), path)
        out: Dict[str, object] = {"images": samples, "path": path,
                                  "seconds": {"sample": t1 - t0}}
        if val_loader is not None:
            imgs = next(iter(val_loader))[:n_samples]
            self._sync()
            t2 = time.perf_counter()
            decoded = self.reconstruct(imgs)
            self._sync()
            out["seconds"]["reconstruct"] = time.perf_counter() - t2
            both = np.concatenate([self.to_uint8(np.asarray(imgs)), self.to_uint8(decoded)])
            out["recon_path"] = os.path.join(self.run_dir, f"val_recon_epoch{epoch}.jpg")
            out["reconstructions"] = decoded
            save_image(make_grid(both, nrow=n_samples), out["recon_path"])
        self.logger.info("VAE: %d samples %s in %.3f s -> %s", n_samples,
                         tuple(samples.shape), t1 - t0, path)
        return out

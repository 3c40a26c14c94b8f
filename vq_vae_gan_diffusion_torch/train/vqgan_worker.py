"""Stage-1 worker: VQVAE / VQGAN training (PyTorch counterpart of the JAX
``train/vqgan_worker.py``).

One step, as the JAX step computes it:

- the VQVAE forward on the batch (in eval mode: the JAX step applies no
  dropout), under ``torch.utils.checkpoint`` when
  ``architecture.vqvae.remat`` is set;
- the per-pixel map ``rec_factor * |x - x̂| + perceptual_factor * LPIPS``
  (LPIPS [B, 1, 1, 1] broadcast; skipped at factor 0), times the
  InterHand26M hand mask where the dataset asks for it, and its mean;
- ``g_loss = -mean(D(x̂))`` with the discriminator's parameters detached and
  its running statistics left as they are;
- adaptive ``λ = 0.8 * clamp(‖∂prl/∂w‖ / (‖∂g_loss/∂w‖ + 1e-4), 0, 1e4)``,
  ``w`` the decoder's last conv weight, detached (``lambda_mode`` grad2 or
  shared; ``off`` pins it to 1, ``vqvae`` mode to 0). The JAX step takes the
  two gradients on a second decode of the detached ``z_q`` with the
  pre-update parameters; that decode is the step's own decode, so the port
  takes them on the step's graph; under data parallelism both are averaged
  over the data ranks before their norms;
- ``vq_loss = prl + q_loss + df * λ * g_loss`` with ``df =
  adopt_weight(disc_factor, step, disc_start)`` on the step count before
  the update;
- the hinge loss ``gan_loss = df * 0.5 * (mean relu(1 - D(x)) + mean relu(1 +
  D(x̂)))`` on batch statistics, the real call then the fake call moving the
  running statistics; ``x̂`` is not detached, so the generator also gets the
  hinge's gradient (the reference's ``retain_graph`` order);
- one backward of ``vq_loss + gan_loss``: the generator gets ∂vq_loss +
  ∂gan_loss, the discriminator ∂gan_loss alone; then the discriminator's
  and the generator's Adam steps (eps 1e-8; ``gradient_accumulate_every``
  through :func:`.base.maybe_accumulate`).

Under ``--bf16`` the forward runs under the worker's autocast (the
VQVAE, LPIPS and the discriminator in bf16 on f32 parameters, the JAX
step's ``dtype=bfloat16``); the codebook's distances, the BatchNorm
statistics and the losses stay f32.

The metrics are the JAX step's: ``vq_loss``, ``gan_loss``, ``q_loss``,
``perceptual_rec_loss``, ``lambda``, ``disc_factor``, as 0-d tensors on the
worker's device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from ..checkpoint import read_training_checkpoint, restore
from ..config import Config, resolve_img_channels
from ..models.blocks import at_least_f32
from ..models.discriminator import Discriminator
from ..models.lpips import load_lpips
from ..models.vqvae import VQVAE, adopt_weight
from ..parallel import all_reduce_mean
from ..utils import make_grid, save_gif, save_image
from .base import TrainingWorker, Worker, maybe_accumulate

LAMBDA_MODES = ("grad2", "shared", "off")


@dataclasses.dataclass
class VQGANState:
    """The trained modules, their optimizers and the step count. ``disc``
    and ``opt_d`` are None in ``vqvae`` mode. The discriminator's running
    statistics are its buffers."""

    vqvae: VQVAE
    disc: Optional[Discriminator]
    opt_g: Any
    opt_d: Any
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"vqvae": self.vqvae.state_dict(),
                "disc": None if self.disc is None else self.disc.state_dict(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": None if self.opt_d is None else self.opt_d.state_dict(),
                "step": self.step}

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        self.vqvae.load_state_dict(tree["vqvae"], strict=True)
        self.opt_g.load_state_dict(tree["opt_g"])
        if self.disc is not None:
            self.disc.load_state_dict(tree["disc"], strict=True)
            self.opt_d.load_state_dict(tree["opt_d"])
        self.step = int(tree["step"])


class VQGANVQVAEWorker(TrainingWorker):
    """The JAX ``VQGANVQVAEWorker``: ``vqgan`` and ``vqvae`` modes."""

    def __init__(self, config: Config, run_dir: str, logger=None, debug: bool = False,
                 seed: int = 0, save_ckpt_dir: Optional[str] = None,
                 device: Optional[str] = None, dtype: torch.dtype = torch.float32):
        super().__init__(config, run_dir, logger, debug, seed, save_ckpt_dir, device, dtype)
        self.model_name = config.architecture.model_name
        self.is_gan = "vqgan" in self.model_name
        tr = config.trainer.vqvae
        self.lr, self.betas = float(tr.learning_rate), (float(tr.beta1), float(tr.beta2))
        dcfg = config.trainer.descriminator
        self.disc_factor, self.disc_start = float(dcfg.disc_factor), int(dcfg.disc_start)
        self.perceptual_factor = float(tr.perceptual_loss_factor)
        self.rec_factor = float(tr.rec_loss_factor)
        self.lambda_mode = str(tr.get("lambda_mode", "grad2"))
        if self.lambda_mode not in LAMBDA_MODES:
            raise ValueError(f"lambda_mode {self.lambda_mode!r}; expected one of {LAMBDA_MODES}")
        self.remat = bool(config.architecture.vqvae.get("remat", False))
        self.use_hand_mask = (bool(config.dataset.get("get_hand_mask", False))
                              and self.dataset_name == "InterHand26M")
        self.lpips = load_lpips(tr.get("perceptual_weights_path")).to(self.device)
        self.gif_frames: list = []

    # -- state ---------------------------------------------------------------
    def init_state(self) -> VQGANState:
        """Seeded fresh weights (VQVAE, then discriminator, from one
        ``torch.Generator(seed)``) and fresh optimizers; a training
        checkpoint at ``architecture.vqvae.resume_path`` replaces them all,
        a bare VQVAE ``state_dict`` or a port bundle there the VQVAE alone."""
        gen = torch.Generator().manual_seed(self.seed)
        vqvae = VQVAE.from_config(self.config)
        vqvae.init_weights(gen)
        disc = None
        if self.is_gan:
            disc = Discriminator(resolve_img_channels(self.config))
            disc.init_weights(gen)
        state = self.make_state(vqvae, disc)
        n = sum(p.numel() for p in vqvae.parameters())
        self.logger.info("VQVAE params: %.1fM (gan=%s)", n / 1e6, self.is_gan)
        resume = self.config.architecture.vqvae.get("resume_path")
        if resume:
            tree = read_training_checkpoint(str(resume))
            if tree is not None:
                self.state = state
                self.load_checkpoint_tree(tree)
                self.logger.info("VQGAN state resumed from %s at step %d", resume, state.step)
            else:
                restore(str(resume), {"vqvae": vqvae}, self.logger, "stage-1")
        return state

    def make_state(self, vqvae: VQVAE, disc: Optional[Discriminator]) -> VQGANState:
        """Move ``vqvae`` and ``disc`` to the device and give them fresh
        optimizers."""
        tr = self.config.trainer.vqvae

        def adam(module):
            return maybe_accumulate(torch.optim.Adam(module.parameters(), lr=self.lr,
                                                     betas=self.betas, eps=1e-8), tr)
        vqvae = vqvae.to(self.device).eval()
        if disc is not None:
            disc = disc.to(self.device)
        return VQGANState(vqvae, disc, adam(vqvae), None if disc is None else adam(disc))

    def checkpoint_tree(self) -> Dict[str, Any]:
        return {"state": self.state.state_dict(), "step": self.global_step}

    def load_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        self.state.load_state_dict(tree["state"])
        self.global_step = int(tree["step"])

    # -- the step ------------------------------------------------------------
    def _perceptual_rec(self, imgs: torch.Tensor, decoded: torch.Tensor,
                        mask: Optional[torch.Tensor]) -> torch.Tensor:
        prl = self.rec_factor * (imgs - at_least_f32(decoded)).abs()
        if self.perceptual_factor != 0.0:
            prl = prl + self.perceptual_factor * at_least_f32(self.lpips(imgs, decoded))
        if mask is not None:
            prl = prl * mask
        return prl.mean()

    def _hand_mask(self, imgs: torch.Tensor) -> Optional[torch.Tensor]:
        """The InterHand26M weighting: the denormalised red channel > 20/255."""
        if not self.use_hand_mask:
            return None
        red = imgs[..., 0] * self.std[0] + self.mean[0]
        return (red > 20.0 / 255.0).to(imgs.dtype)[..., None]

    def _lambda(self, state: VQGANState, prl: torch.Tensor, g_loss: torch.Tensor) -> torch.Tensor:
        if self.lambda_mode == "off":
            return torch.ones((), device=prl.device)
        w = state.vqvae.decoder.model[-1].weight
        g_prl, = torch.autograd.grad(prl, w, retain_graph=True)
        g_gan, = torch.autograd.grad(g_loss, w, retain_graph=True)
        all_reduce_mean([g_prl, g_gan], self.mesh)      # the global batch's gradients
        return (0.8 * torch.clamp(g_prl.norm() / (g_gan.norm() + 1e-4), 0.0, 1e4)).detach()

    def train_step(self, state: VQGANState, batch, generator: Optional[torch.Generator] = None):
        """One step on ``batch`` [B, H, W, C] (normalised, as the loader gives
        it) -> (state, metrics). The state's modules and optimizers move in
        place. ``generator`` is taken for the loop's sake and unused: the
        step draws no noise (the JAX step's rng is unused too)."""
        imgs = self.batch_to_device(batch) if not isinstance(batch, torch.Tensor) else batch
        vqvae, disc = state.vqvae.eval(), state.disc
        df = adopt_weight(self.disc_factor, state.step, self.disc_start) if self.is_gan else 0.0
        mask = self._hand_mask(imgs)
        with self.autocast():
            if self.remat:
                decoded, indices, q_loss = checkpoint(vqvae, imgs, use_reentrant=False)
            else:
                decoded, indices, q_loss = vqvae(imgs)
            prl = self._perceptual_rec(imgs, decoded, mask)
            zero = torch.zeros((), device=imgs.device)
            if self.is_gan:
                frozen = {k: v.detach() for k, v in disc.named_parameters()}
                g_loss = -at_least_f32(functional_call(disc, frozen, (decoded,))).mean()
                lam = self._lambda(state, prl, g_loss)
                vq_loss = prl + q_loss + df * lam * g_loss
                d_real = at_least_f32(disc(imgs, update_stats=True))
                d_fake = at_least_f32(disc(decoded, update_stats=True))
                gan_loss = df * 0.5 * (F.relu(1.0 - d_real).mean() + F.relu(1.0 + d_fake).mean())
                total = vq_loss + gan_loss
            else:
                lam, gan_loss = zero, zero
                vq_loss = total = prl + q_loss
        state.opt_g.zero_grad()
        if self.is_gan:
            state.opt_d.zero_grad()
        total.backward()
        self.reduce_gradients(vqvae, *([disc] if self.is_gan else []))
        if self.is_gan:
            state.opt_d.step()
        state.opt_g.step()
        state.step += 1
        metrics = {"vq_loss": vq_loss, "gan_loss": gan_loss, "q_loss": q_loss,
                   "perceptual_rec_loss": prl, "lambda": lam,
                   "disc_factor": torch.full((), df, device=imgs.device)}
        return state, {k: v.detach() for k, v in metrics.items()}

    # -- artifacts -------------------------------------------------------------
    @torch.no_grad()
    def reconstruct(self, imgs) -> torch.Tensor:
        """The VQVAE's reconstruction of ``imgs`` [B, H, W, C]."""
        imgs = self.batch_to_device(imgs) if not isinstance(imgs, torch.Tensor) else imgs
        return self.state.vqvae.eval()(imgs)[0]

    def log_artifacts(self, batch: torch.Tensor, epoch: int, index: int) -> None:
        """The first 8 images of ``batch`` over their reconstructions, added as
        a frame to ``reconstruction.gif``."""
        imgs = batch[:8]
        both = np.concatenate([self.to_uint8(imgs), self.to_uint8(self.reconstruct(imgs))])
        self.gif_frames.append(make_grid(both, nrow=8))
        save_gif(self.gif_frames, os.path.join(self.run_dir, "reconstruction.gif"))

    def generate_images(self, val_loader=None, n_samples: int = 16,
                        epoch: int = 0) -> Optional[Dict[str, object]]:
        """:func:`write_reconstructions` of the trained VQVAE."""
        if val_loader is None:
            return None
        return write_reconstructions(self, self.state.vqvae, val_loader, n_samples, epoch)


@torch.no_grad()
def write_reconstructions(worker: Worker, vqvae: VQVAE, val_loader, n_samples: int = 16,
                          epoch: int = 0) -> Dict[str, object]:
    """The first ``n_samples`` images of ``val_loader``'s first batch over
    ``vqvae``'s reconstructions, as ``val_recon_epoch{epoch}.jpg`` in the
    worker's run dir."""
    imgs = next(iter(val_loader))[:n_samples]
    x = torch.as_tensor(np.asarray(imgs, np.float32)).to(worker.device)
    decoded = vqvae.eval()(x)[0]
    both = np.concatenate([worker.to_uint8(np.asarray(imgs)), worker.to_uint8(decoded)])
    path = os.path.join(worker.run_dir, f"val_recon_epoch{epoch}.jpg")
    save_image(make_grid(both, nrow=len(imgs)), path)
    worker.logger.info("reconstructions of %d validation images -> %s", len(imgs), path)
    return {"images": decoded, "path": path}

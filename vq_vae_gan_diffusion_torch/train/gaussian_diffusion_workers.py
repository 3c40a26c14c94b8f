"""Pixel-space Gaussian diffusion workers (PyTorch counterparts of the JAX
``train/gaussian_diffusion_workers.py``).

``gaussiandiffusion2d``: the reference ``worker/gaussianDiffusion2DWorker.py``
on grayscale images. The image's rows are the channels of the Conv1d U-Net
(``models/unet1d.py``, ``architecture.gaussiandiffusion2d.unet_base_dim`` 64
and ``unet_dim_mults`` (1, 2, 4, 8) unless the config says otherwise) over
its columns: x0 [B, H, W] enters as [B, C = H, L = W], and the process is
:class:`..diffusion.gaussian2d.GaussianDiffusion2D` on raw sequences. One
step, as the JAX step computes it:

- the noise MSE of :meth:`GaussianDiffusion2D.loss`;
- Adam (``trainer.gaussiandiffusion2d.adam_betas``, (0.9, 0.99) where it
  is a string that does not parse) behind ``optax.clip_by_global_norm(1.0)``
  (:class:`.base.ClipByGlobalNorm`);
- the EMA copy moves with decay 0.9999 on steps whose count before the
  step is a multiple of 10; it starts as a copy.

``generate_images`` samples 4 images with the EMA copy, whatever
``n_samples`` says, as the JAX worker: DDIM from uniform noise [4, H, W],
min-max normalised over the whole batch, four to a row, as
``Generating_epoch{e:03d}.jpg``. The metric is ``loss``; checkpoints hold
the U-Net, its EMA copy, the optimizer and the step.

``gaussiandiffusion3d``: a DDPM on the images themselves, the reference
``worker/gaussianDiffusion3DWorker.py``. The denoiser is the ShuffleNet
U-Net with ``dim_mults (2, 4)`` over the images' own channels
(``architecture.gaussiandiffusion3d.model_base_dim`` wide), the process
:class:`..diffusion.gaussian3d.GaussianDiffusion3D` on [B, H, W, C] with the
noise-MSE loss and DDPM sampling. One step, as the JAX step computes it:

- the noise MSE through the U-Net in train mode (its BatchNorm running
  statistics move);
- AdamW, OneCycle and the EMA of :mod:`.diffusion_trainer`, beta2 AdamW's
  default 0.999 (this worker configures none).

The U-Net starts from the flax-style init redrawn with torch's defaults
(:func:`..utils.init_utils.torch_like_reinit`) unless
``trainer.gaussiandiffusion3d.torch_init`` is false. ``generate_images``
samples the EMA copy with ``ddpm_sample`` (clipped unless ``no_clip``),
folded through the CUDA kernels unless ``fused_sampler`` is off, clips to
[0, 1] and writes ``samples_epoch{e}.jpg`` six to a row. The metric is
``loss``; checkpoints hold the U-Net, its EMA copy, the optimizer, the
step and the count of updates.
"""

from __future__ import annotations

import copy
import os
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..checkpoint import read_training_checkpoint, restore
from ..config import Config, resolve_img_channels, resolve_img_size
from ..diffusion.gaussian2d import GaussianDiffusion2D, GaussianDiffusion2DConfig
from ..diffusion.gaussian3d import GaussianDiffusion3D
from ..models.shuffle_infer import eval_forward
from ..models.unet1d import Unet1D
from ..models.unet_shuffle import ShuffleUNet
from ..utils import make_grid, save_image, tracing
from ..utils.init_utils import torch_like_reinit
from .base import ClipByGlobalNorm, maybe_accumulate
from .diffusion_trainer import DiffusionState, DiffusionTrainer

DIM_MULTS = (2, 4)          # the reference train.py's U-Net for this worker
TIME_EMBEDDING_DIM = 256
ADAMW_BETA2 = 0.999


class GaussianDiffusion2DWorker(DiffusionTrainer):
    model_name = "gaussiandiffusion2d"
    ema_decay, ema_every, n_samples, clip_norm = 0.9999, 10, 4, 1.0

    def __init__(self, config: Config, run_dir: str, logger=None, debug: bool = False,
                 seed: int = 0, save_ckpt_dir: Optional[str] = None,
                 device: Optional[str] = None, dtype: torch.dtype = torch.float32):
        super().__init__(config, run_dir, logger, debug, seed, save_ckpt_dir, device, dtype)
        dcfg = config.architecture.gaussiandiffusion2d
        self.trainer_cfg = tr = config.trainer.gaussiandiffusion2d
        self.img_size = resolve_img_size(config)
        self.unet_kwargs = dict(dim=int(dcfg.get("unet_base_dim", 64)),
                                dim_mults=tuple(dcfg.get("unet_dim_mults", (1, 2, 4, 8))),
                                channels=self.img_size, out_dim=self.img_size)
        self.process = GaussianDiffusion2D(GaussianDiffusion2DConfig(
            seq_length=self.img_size, timesteps=int(dcfg.diffusion_steps),
            sampling_timesteps=int(dcfg.sampling_steps), diffusion_type="gaussiandiffusion2d"))
        self.lr = float(tr.learning_rate)
        betas = tr.get("adam_betas", (0.9, 0.99))
        self.betas = (0.9, 0.99) if isinstance(betas, str) else tuple(map(float, betas))

    def build_unet(self) -> Unet1D:
        return Unet1D(**self.unet_kwargs)

    # -- state ---------------------------------------------------------------
    def init_state(self) -> DiffusionState:
        """A U-Net drawn flax-style from a generator seeded by ``seed`` on the
        worker's device, its EMA copy and a fresh optimizer; also set as the
        worker's state. A training checkpoint of this worker at
        ``architecture.gaussiandiffusion2d.resume_path`` replaces it whole."""
        unet = self.build_unet()
        unet.init_weights(torch.Generator().manual_seed(self.seed))
        unet = unet.to(self.device)
        opt = ClipByGlobalNorm(torch.optim.Adam(unet.parameters(), lr=self.lr, betas=self.betas,
                                                eps=1e-8), self.clip_norm)
        self.state = DiffusionState(unet, copy.deepcopy(unet).eval().requires_grad_(False),
                                    maybe_accumulate(opt, self.trainer_cfg))
        n = sum(p.numel() for p in unet.parameters())
        self.logger.info("gaussiandiffusion2d U-Net params: %.1fM", n / 1e6)
        resume = self.config.architecture.gaussiandiffusion2d.get("resume_path")
        tree = read_training_checkpoint(str(resume), "pixel") if resume else None
        if tree is not None:
            self.load_checkpoint_tree(tree)
            self.logger.info("state resumed from %s at step %d", resume, self.state.step)
        return self.state

    def load(self, path: str) -> None:
        """Load a training checkpoint of this worker whole, or a bare Conv1d
        U-Net ``state_dict`` (``tools/export_torch_checkpoint.py``'s
        ``export_unet1d``; ``--ema`` gives the weights the JAX worker samples
        with) into the U-Net and its EMA copy alike; a path where nothing
        exists only warns, any other unreadable path raises."""
        tree = read_training_checkpoint(path, "pixel")
        if tree is not None:
            self.load_checkpoint_tree(tree)
            self.logger.info("restored the training state of %s", path)
        elif restore(path, {"unet": self.state.unet}, self.logger, "gaussiandiffusion2d"):
            self.state.ema.load_state_dict(self.state.unet.state_dict())

    # -- the step ------------------------------------------------------------
    def train_step(self, state: DiffusionState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        """One step on images ``batch`` [B, H, W, 1] (or [B, H, W]) ->
        (state, metrics). ``t`` and ``noise`` come from ``generator`` unless
        given."""
        with tracing.span("train.step"):
            imgs = batch if isinstance(batch, torch.Tensor) else self.batch_to_device(batch)
            x0 = imgs[..., 0] if imgs.dim() == 4 else imgs
            unet = state.unet.train()
            self.process.model_fn = lambda x, self_cond, tt: unet(x, self_cond, tt)
            with tracing.span("train.forward"), self.autocast():
                loss = self.process.loss(x0, generator, t=t, noise=noise)
            self._step(state, loss, self.ema_decay, self.ema_every)
            return state, {"loss": loss.detach()}

    # -- artifacts -------------------------------------------------------------
    @torch.no_grad()
    def sample(self, generator: Optional[torch.Generator] = None, unet: Optional[Unet1D] = None,
               *, xt: Optional[torch.Tensor] = None, step_noise=None) -> torch.Tensor:
        """4 sequences [4, H, W]: the DDIM chain of ``unet`` (default the EMA
        copy) from uniform noise. Noise from ``generator`` (default the
        worker's) or injected (``xt``, ``step_noise``)."""
        unet = (self.state.ema if unet is None else unet).eval()

        def model_fn(x, self_cond, t):
            with self.autocast():
                return unet(x, self_cond, t)
        self.process.model_fn = model_fn
        gen = self.generator if generator is None else generator
        if xt is None:
            xt = torch.rand((self.n_samples, self.img_size, self.img_size), generator=gen,
                            device=gen.device)
        noise = {"step_noise": step_noise} if step_noise is not None else {"generator": gen}
        return self.process.sample(self.n_samples, xt, **noise)

    def generate_images(self, val_loader=None, n_samples: Optional[int] = None,
                        epoch: int = 0) -> Dict[str, object]:
        """Sample 4 images with the EMA copy (``n_samples`` and ``val_loader``
        are ignored, as in the JAX worker), min-max normalise them over the
        batch and write ``Generating_epoch{epoch:03d}.jpg``. Returns the
        images, the grid's path and the sampling seconds (the device
        synchronised before and after)."""
        self._sync()
        t0 = time.perf_counter()
        images = self.sample()
        self._sync()
        sec = time.perf_counter() - t0
        imgs = images.float().cpu().numpy()
        imgs = (imgs - imgs.min()) / max(imgs.max() - imgs.min(), 1e-9)
        path = os.path.join(self.run_dir, f"Generating_epoch{epoch:03d}.jpg")
        save_image(make_grid((imgs[..., None] * 255).astype(np.uint8), nrow=4), path)
        self.logger.info("sampled %d images in %.3f s -> %s", len(imgs), sec, path)
        return {"images": images, "path": path, "seconds": {"sample": sec}}


class GaussianDiffusion3DWorker(DiffusionTrainer):
    model_name = "gaussiandiffusion3d"

    def __init__(self, config: Config, run_dir: str, logger=None, debug: bool = False,
                 seed: int = 0, save_ckpt_dir: Optional[str] = None,
                 device: Optional[str] = None, num_iters_per_epoch: int = 100,
                 dtype: torch.dtype = torch.float32):
        super().__init__(config, run_dir, logger, debug, seed, save_ckpt_dir, device, dtype)
        dcfg = config.architecture.gaussiandiffusion3d
        tr = config.trainer.gaussiandiffusion3d
        self.img_size, self.channels = resolve_img_size(config), resolve_img_channels(config)
        self.timesteps = int(dcfg.diffusion_steps)
        self.base_dim = int(dcfg.model_base_dim)
        self.n_samples = int(dcfg.get("n_samples", 16))
        self.process = GaussianDiffusion3D((self.img_size, self.img_size), self.channels,
                                           self.timesteps, int(dcfg.sampling_steps), None,
                                           "noise_mse", "ddpm")
        self.no_clip = bool(tr.get("no_clip", False))
        self.fused_sampler = tr.get("fused_sampler", True)
        self.torch_init = bool(tr.get("torch_init", True))
        self._setup_schedule(tr, num_iters_per_epoch, ADAMW_BETA2)

    def build_unet(self) -> ShuffleUNet:
        return ShuffleUNet(self.timesteps, TIME_EMBEDDING_DIM, self.channels, self.channels,
                           self.base_dim, DIM_MULTS)

    # -- state ---------------------------------------------------------------
    def init_state(self) -> DiffusionState:
        """A U-Net drawn from a generator seeded by ``seed`` (flax-style, then
        torch's defaults under ``torch_init``) on the worker's device, its
        EMA copy and a fresh optimizer; also set as the worker's state. A
        training checkpoint of this worker at
        ``architecture.gaussiandiffusion3d.resume_path`` replaces it whole."""
        unet = self.build_unet()
        gen = torch.Generator().manual_seed(self.seed)
        unet.init_weights(gen)
        if self.torch_init:
            torch_like_reinit(unet, gen)
        self.state = self._new_state(unet.to(self.device))
        n = sum(p.numel() for p in unet.parameters())
        self.logger.info("gaussiandiffusion3d U-Net params: %.1fM", n / 1e6)
        resume = self.config.architecture.gaussiandiffusion3d.get("resume_path")
        tree = read_training_checkpoint(str(resume), "pixel") if resume else None
        if tree is not None:
            self.load_checkpoint_tree(tree)
            self.logger.info("state resumed from %s at step %d", resume, self.state.step)
        return self.state

    def load(self, path: str) -> None:
        """Load a training checkpoint of this worker whole, or a bare
        ShuffleNet-denoiser ``state_dict`` (as ``tools/export_torch_checkpoint.py``
        writes it for this family; ``--ema`` gives the weights the JAX worker
        samples with) into the U-Net and its EMA copy alike; a path where
        nothing exists only warns, any other unreadable path raises."""
        tree = read_training_checkpoint(path, "pixel")
        if tree is not None:
            self.load_checkpoint_tree(tree)
            self.logger.info("restored the training state of %s", path)
        elif restore(path, {"unet": self.state.unet}, self.logger, "gaussiandiffusion3d"):
            self.state.ema.load_state_dict(self.state.unet.state_dict())

    # -- the step ------------------------------------------------------------
    def train_step(self, state: DiffusionState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        """One step on images ``batch`` [B, H, W, C] -> (state, metrics). ``t``
        and ``noise`` come from ``generator`` unless given."""
        with tracing.span("train.step"):
            imgs = batch if isinstance(batch, torch.Tensor) else self.batch_to_device(batch)
            unet = state.unet.train()
            self.process.model_fn = lambda x, self_cond, tt: unet(x, None, tt)
            with tracing.span("train.forward"), self.autocast():
                loss = self.process.loss(imgs, generator, t=t, noise=noise)
            self._update(state, loss)
            return state, {"loss": loss.detach()}

    # -- artifacts -------------------------------------------------------------
    @torch.no_grad()
    def sample(self, n: int, generator: Optional[torch.Generator] = None,
               unet: Optional[ShuffleUNet] = None, **noise) -> torch.Tensor:
        """``n`` images [n, H, W, C] in [0, 1] before clipping: the DDPM chain
        of ``unet`` (default the EMA copy), clipped unless ``no_clip``. Noise
        from ``generator`` (default the worker's) or injected (``x_T``,
        ``step_noise``)."""
        fwd = eval_forward(self.state.ema if unet is None else unet, self.fused_sampler,
                           self.dtype)
        self.process.model_fn = lambda x, self_cond, t: fwd(x, t)
        if not noise:
            noise = {"generator": self.generator if generator is None else generator}
        return self.process.ddpm_sample(n, device=self.device,
                                        clipped_reverse_diffusion=not self.no_clip, **noise)

    def generate_images(self, val_loader=None, n_samples: Optional[int] = None,
                        epoch: int = 0) -> Dict[str, object]:
        """Sample ``n_samples`` (default ``n_samples`` of the config) images
        with the EMA copy and write ``samples_epoch{epoch}.jpg``. Returns the
        images, the grid's path and the sampling seconds (the device
        synchronised before and after). ``val_loader`` is ignored, as in the
        JAX worker."""
        n = n_samples or self.n_samples
        self._sync()
        t0 = time.perf_counter()
        images = self.sample(n)
        self._sync()
        sec = time.perf_counter() - t0
        grid = (np.clip(images.float().cpu().numpy(), 0, 1) * 255).astype(np.uint8)
        path = os.path.join(self.run_dir, f"samples_epoch{epoch}.jpg")
        save_image(make_grid(grid, nrow=6), path)
        self.logger.info("sampled %d images in %.3f s -> %s", n, sec, path)
        return {"images": images, "path": path, "seconds": {"sample": sec}}

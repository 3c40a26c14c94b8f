"""Pixel-space Gaussian diffusion trainer (PyTorch counterpart of the root
``train_diffusion.py``): the Conv2d U-Net ``models/unet2d.Unet2DPixel``
trained as a DDPM on images, sampled with DDIM.

    python -m vq_vae_gan_diffusion_torch.train_diffusion [--dataset cifar10] \\
        [--batch-size 500] [--epochs 50] [--timesteps 1000] \\
        [--sampling-timesteps 500] [--eta 0] [--lr 2e-4] [--ema-decay 0.999] \\
        [--objective pred_noise|pred_x0|pred_v] [--dim 64] [--img-size N] \\
        [--log-dir zlog] [--debug] [--seed 42] [--device cuda|cpu] [--bf16]

The root CLI's defaults: the U-Net at ``--dim`` 64, mults (1, 2, 4, 8),
dropout 0.1 while it trains, a linear schedule of ``--timesteps`` steps,
Adam at ``--lr`` (β 0.9, 0.999, eps 1e-8) and an EMA copy moved at
``--ema-decay`` after every step. A step draws t ~ U[0, T) and the noise
from the trainer's generator, then takes ``diffusion_loss`` against the
objective's target. Images are 32² for mnist (1 channel) and cifar10, 256²
otherwise, normalised by (0.5, 0.5); where the dataset is not under
``--data-root``, a warning and ``max(4 * batch, 64)`` synthetic images.
Each epoch writes ``metrics.jsonl`` (the epoch's mean loss and seconds) and
a checkpoint ``ckpt/step_<step>.pth`` (the U-Net, Adam, the EMA, the
epoch; the newest 3 kept, as the root CLI's Orbax manager keeps them) under ``<log-dir>/<dataset>/<time>_diffusion/``; every 5th epoch
the EMA samples 64 images through ``--sampling-timesteps`` DDIM steps at
``--eta``, written as ``samples_epoch_<e>.png``. ``--debug`` trains one
epoch of 11 batches of 2 and samples 4 images through 8 DDIM steps.

Weights come from a ``torch.Generator`` seeded by ``--seed`` (flax-style
init), the steps' t, noise and the samples from a generator on the device
seeded by it, dropout's masks from torch's global generator seeded by it.
The public functions take and return NHWC images, as the root CLI's do;
the U-Net runs NCHW. ``--bf16`` runs the U-Net's training forward and its
samples under bf16 autocast (the root CLI's ``dtype=bfloat16``; the loss
in f32; the U-Net, Adam, the EMA and the checkpoints f32). It runs on CUDA
unless ``--device cpu``; with no GPU it raises. The root CLI's
``--platform`` (JAX-only) is not ported.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import os
import sys
import time
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from .checkpoint import write_checkpoint
from .diffusion.gaussian import ddim_sample, diffusion_loss, make_schedule
from .models.unet2d import Unet2DPixel
from .utils.device import compute_autocast
from .utils.ema import ema_update


@dataclasses.dataclass
class PixelDDPMState:
    """The U-Net, its EMA copy, Adam and the step count."""

    unet: Unet2DPixel
    ema: Unet2DPixel
    opt: Any
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"params": self.unet.state_dict(), "opt_state": self.opt.state_dict(),
                "ema": self.ema.state_dict(), "step": self.step}


class PixelDDPM:
    """The root CLI's U-Net, schedule, step and sampler on one device."""

    def __init__(self, channels: int, img_size: int, dim: int = 64,
                 dim_mults: Tuple[int, ...] = (1, 2, 4, 8), dropout: float = 0.1,
                 timesteps: int = 1000, sampling_timesteps: int = 500, eta: float = 0.0,
                 lr: float = 2e-4, ema_decay: float = 0.999, objective: str = "pred_noise",
                 seed: int = 42, device: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        from .utils import resolve_device

        self.channels, self.img_size = channels, img_size
        self.dim, self.dim_mults, self.dropout = dim, tuple(dim_mults), dropout
        self.sched = make_schedule(timesteps, "linear")
        self.timesteps, self.sampling_timesteps, self.eta = timesteps, sampling_timesteps, eta
        self.lr, self.ema_decay, self.objective = lr, ema_decay, objective
        self.seed = seed
        self.device = resolve_device(device)
        self.dtype = dtype
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self.state: Optional[PixelDDPMState] = None

    def lr_fn(self, step: int) -> float:
        """Adam's learning rate at ``step``: constant."""
        return self.lr

    def init_state(self) -> PixelDDPMState:
        """The U-Net drawn flax-style from ``torch.Generator(seed)``, its EMA
        copy equal to it, a fresh Adam; also kept as ``self.state``."""
        unet = Unet2DPixel(dim=self.dim, dim_mults=self.dim_mults, channels=self.channels,
                           dropout=self.dropout)
        unet.init_weights(torch.Generator().manual_seed(self.seed))
        unet = unet.to(self.device)
        ema = copy.deepcopy(unet).eval().requires_grad_(False)
        opt = torch.optim.Adam(unet.parameters(), lr=self.lr, betas=(0.9, 0.999), eps=1e-8)
        self.state = PixelDDPMState(unet, ema, opt)
        return self.state

    def train_step(self, state: PixelDDPMState, imgs: torch.Tensor,
                   generator: Optional[torch.Generator] = None, *,
                   t: Optional[torch.Tensor] = None, noise: Optional[torch.Tensor] = None):
        """One step on ``imgs`` [B, H, W, C] -> (state, {"loss"}): t and the
        noise [B, H, W, C] from ``generator`` (the trainer's by default)
        unless given; the U-Net in train mode (its dropout on); Adam, then
        the EMA. The state's modules and optimizer move in place."""
        gen = generator if generator is not None else self.generator
        b = imgs.shape[0]
        if t is None:
            t = torch.randint(0, self.timesteps, (b,), generator=gen, device=gen.device)
        if noise is None:
            noise = torch.randn(imgs.shape, generator=gen, device=gen.device)
        x0 = imgs.permute(0, 3, 1, 2)
        noise = noise.to(x0.device, x0.dtype).permute(0, 3, 1, 2)
        unet = state.unet.train()
        with compute_autocast(x0.device, self.dtype):
            loss, _ = diffusion_loss(self.sched, lambda x, c, tt: unet(x, c, tt), x0, None,
                                     t.to(x0.device), noise, self.objective)
        state.opt.zero_grad()
        loss.backward()
        state.opt.step()
        ema_update(state.ema, state.unet, self.ema_decay)
        state.step += 1
        return state, {"loss": loss.detach()}

    @torch.no_grad()
    def sample(self, state: PixelDDPMState, n: int, generator: Optional[torch.Generator] = None,
               x_t: Optional[torch.Tensor] = None,
               step_noise: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """``n`` images [n, H, W, C] from the EMA through the DDIM chain:
        x_T [n, H, W, C] and each step's noise from ``generator`` (the
        trainer's by default) unless given."""
        ema = state.ema.eval()
        gen = generator if generator is not None else self.generator
        if x_t is None:
            x_t = torch.randn(n, self.img_size, self.img_size, self.channels, generator=gen,
                              device=gen.device)
        dtype = next(ema.parameters()).dtype
        x_t = x_t.to(self.device, dtype).permute(0, 3, 1, 2)
        if step_noise is not None:
            step_noise = [z.to(self.device, dtype).permute(0, 3, 1, 2) for z in step_noise]
        def fwd(x, c, tt):
            with compute_autocast(x.device, self.dtype):
                return ema(x, c, tt)
        out = ddim_sample(self.sched, fwd, x_t, eta=self.eta,
                          sampling_timesteps=self.sampling_timesteps, objective=self.objective,
                          generator=gen, step_noise=step_noise)
        return out.permute(0, 2, 3, 1)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--dataset", default="cifar10",
                        choices=["mnist", "cifar10", "Oxford102Flower", "synthetic"])
    parser.add_argument("--data-root", default="data")
    parser.add_argument("--batch-size", type=int, default=500)
    parser.add_argument("--epochs", type=int, default=50)
    parser.add_argument("--timesteps", type=int, default=1000)
    parser.add_argument("--sampling-timesteps", type=int, default=500)
    parser.add_argument("--eta", type=float, default=0.0)
    parser.add_argument("--lr", type=float, default=2e-4)
    parser.add_argument("--ema-decay", type=float, default=0.999)
    parser.add_argument("--objective", default="pred_noise",
                        choices=["pred_noise", "pred_x0", "pred_v"])
    parser.add_argument("--dim", type=int, default=64)
    parser.add_argument("--img-size", type=int, default=None)
    parser.add_argument("--log-dir", default="zlog")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", type=str, default=None, choices=["cuda", "cpu"],
                        help="default cuda; raises when no GPU is visible")
    parser.add_argument("--bf16", action="store_true",
                        help="bfloat16 compute (the U-Net's parameters stay f32)")
    return parser


def load_images(dataset: str, data_root: str, batch_size: int, img_size: int, channels: int,
                seed: int, logger):
    """The train split's loader, shuffled, its last short batch dropped;
    synthetic images where the dataset is not on disk."""
    from .data.datasets import (CIFAR10Dataset, MNISTDataset, OxfordFlowersDataset,
                                SyntheticDataset)
    from .data.pipeline import DataLoader
    from .data.transforms import Preprocessor

    try:
        if dataset == "mnist":
            ds = MNISTDataset(data_root, train=True)
        elif dataset == "cifar10":
            ds = CIFAR10Dataset(data_root, train=True)
        elif dataset == "Oxford102Flower":
            ds = OxfordFlowersDataset(data_root, "train")
        else:
            raise FileNotFoundError
    except FileNotFoundError:
        logger.warning("dataset %s unavailable; synthetic fallback", dataset)
        ds = SyntheticDataset(max(batch_size * 4, 64), img_size, channels)
    prep = Preprocessor(img_size, [0.5] * channels, [0.5] * channels, grayscale=channels == 1)
    return DataLoader(ds, batch_size, prep, shuffle=True, drop_last=True, seed=seed)


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, object]:
    """Parse ``argv`` and train; returns the trainer, its state, the run dir,
    each epoch's mean loss and the last samples [n, H, W, C]."""
    from .utils import MetricWriter, make_grid, save_image, setup_logging

    args = build_parser().parse_args(argv)
    if args.debug:
        args.batch_size = 2
        args.sampling_timesteps = 8
    channels = 1 if args.dataset == "mnist" else 3
    img_size = args.img_size or (32 if args.dataset in ("mnist", "cifar10") else 256)
    trainer = PixelDDPM(channels, img_size, dim=args.dim, timesteps=args.timesteps,
                        sampling_timesteps=args.sampling_timesteps, eta=args.eta, lr=args.lr,
                        ema_decay=args.ema_decay, objective=args.objective, seed=args.seed,
                        device=args.device,
                        dtype=torch.bfloat16 if args.bf16 else torch.float32)
    torch.manual_seed(args.seed)
    save_dir = os.path.join(args.log_dir, args.dataset,
                            f"{time.strftime('%Y%m%d-%H%M%S')}_diffusion")
    os.makedirs(save_dir, exist_ok=True)
    logger = setup_logging(save_dir)
    loader = load_images(args.dataset, args.data_root, args.batch_size, img_size, channels,
                         args.seed, logger)
    logger.info("train samples: %d (%d batches)", loader.n, len(loader))
    state = trainer.init_state()
    n_par = sum(p.numel() for p in state.unet.parameters())
    logger.info("U-Net params: %.1fM on %s", n_par / 1e6, trainer.device)
    losses, samples = [], None
    with MetricWriter(save_dir) as metrics:
        for epoch in range(args.epochs):
            t0 = time.perf_counter()
            total, count = torch.zeros((), device=trainer.device), 0
            for i, batch in enumerate(loader):
                imgs = torch.as_tensor(batch).to(trainer.device, non_blocking=True)
                state, out = trainer.train_step(state, imgs)
                total += out["loss"]
                count += 1
                if args.debug and i >= 10:
                    break
            avg = float(total) / max(count, 1)
            dt = time.perf_counter() - t0
            losses.append(avg)
            logger.info("epoch %d: avg loss %.6f (%.1fs, %.1f img/s)", epoch, avg, dt,
                        count * args.batch_size / dt)
            metrics.write(state.step, {"loss": avg, "epoch_time_s": dt})
            write_checkpoint(os.path.join(save_dir, "ckpt"), state.step,
                             {**state.state_dict(), "epoch": epoch})
            if epoch % 5 == 0 or args.debug:
                samples = trainer.sample(state, 4 if args.debug else 64)
                s = samples.float().cpu().numpy()
                logger.info("sample stats: mean %.3f std %.3f", s.mean(), s.std())
                grid = ((np.clip(s, -1, 1) + 1) / 2 * 255).astype(np.uint8)
                save_image(make_grid(grid, nrow=8),
                           os.path.join(save_dir, f"samples_epoch_{epoch}.png"))
            if args.debug:
                break
    logger.info("done")
    return {"trainer": trainer, "state": state, "save_dir": save_dir, "losses": losses,
            "samples": samples}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""What the port's serving workers share: the device, the seeded generator,
the stage-1 checkpoint, and the timed sample -> decode -> grid run."""

from __future__ import annotations

import logging
import os
import time
from typing import Callable, Dict, Optional

import torch
from torch import nn

from ..checkpoint import restore
from ..config import Config
from ..utils import make_grid, resolve_device, save_image, to_uint8


class ServingWorker:
    def __init__(self, config: Config, run_dir: str,
                 logger: Optional[logging.Logger] = None, seed: int = 0,
                 device: Optional[str] = None, dtype: torch.dtype = torch.float32):
        self.config = config
        self.run_dir = run_dir
        self.logger = logger or logging.getLogger("vqgd_torch")
        self.seed = seed
        self.device = resolve_device(device)
        self.dtype = dtype
        ds = config.dataset.dataset_name
        ch = int(config.dataset.img_channels[ds])
        self.mean = list(config.dataset.mean)[:ch] or [0.5]
        self.std = list(config.dataset.std)[:ch] or [0.5]
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def _restore_vqvae(self, vqvae: nn.Module) -> None:
        """The checkpoint at ``architecture.vqvae.resume_path`` (a bare VQVAE
        ``state_dict`` or a port bundle, :mod:`..checkpoint`) replaces the
        seeded VQVAE; a path where nothing exists only warns."""
        resume = self.config.architecture.vqvae.get("resume_path")
        if resume:
            restore(str(resume), {"vqvae": vqvae}, self.logger, "stage-1")

    def _restore(self, path: str, prior: str, module: nn.Module) -> None:
        """Load the checkpoint at ``path``: a port bundle (VQVAE and prior) or
        a bare ``state_dict`` of either, the prior stored under ``prior``."""
        restore(path, {"vqvae": self.composite.vqvae, prior: module}, self.logger, "prior")

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _sample_and_decode(self, sample: Callable[[], torch.Tensor],
                           decode: Callable[[torch.Tensor], torch.Tensor],
                           epoch: int) -> Dict[str, object]:
        """Run ``sample()`` then ``decode(codes)``, synchronising the device
        between phases, and write ``samples_epoch{epoch}.jpg``. Returns the
        codes, the NHWC images, the grid's path and each phase's seconds."""
        self._sync()
        t0 = time.perf_counter()
        codes = sample()
        self._sync()
        t1 = time.perf_counter()
        images = decode(codes)
        self._sync()
        t2 = time.perf_counter()
        grid = make_grid(to_uint8(images.float().cpu().numpy(), self.mean, self.std), nrow=4)
        path = os.path.join(self.run_dir, f"samples_epoch{epoch}.jpg")
        save_image(grid, path)
        self.logger.info("sampled %s codes in %.3f s, decoded in %.3f s -> %s",
                         tuple(codes.shape), t1 - t0, t2 - t1, path)
        return {"codes": codes, "images": images, "path": path,
                "seconds": {"sample": t1 - t0, "decode": t2 - t1}}

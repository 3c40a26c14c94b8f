"""Stage-2 worker (PyTorch counterpart of the JAX ``train/vq_transformer_worker.py``).

This slice ports the serving side only: :meth:`init_state` (a seeded fresh
init), :meth:`load` (a port checkpoint) and :meth:`generate_images` (sample
tokens with the GPT prior, decode them with the frozen VQVAE, write a grid).
Training, AdamW and pkeep come with the training slice.
"""

from __future__ import annotations

import logging
import os
import time
from typing import Dict, Optional

import torch

from ..config import Config
from ..models.vq_transformer import VQTransformer
from ..utils import make_grid, resolve_device, save_image, to_uint8


class VQTransformerWorker:
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
        self.composite: Optional[VQTransformer] = None
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def init_state(self) -> VQTransformer:
        """A fresh VQTransformer with weights drawn from a generator seeded by
        ``seed``, in eval mode on the worker's device. A stage-1 port
        checkpoint at ``architecture.vqvae.resume_path`` replaces the VQVAE."""
        composite = VQTransformer(self.config)
        gen = torch.Generator().manual_seed(self.seed)
        composite.vqvae.init_weights(gen)
        composite.gpt.init_weights(gen)
        resume = self.config.architecture.vqvae.get("resume_path")
        if resume and os.path.isfile(str(resume)):
            state = torch.load(str(resume), map_location="cpu", weights_only=True)
            composite.vqvae.load_state_dict(state["vqvae"], strict=True)
            self.logger.info("frozen VQVAE restored from %s", resume)
        elif resume:
            self.logger.warning("stage-1 checkpoint %s not found; using fresh init", resume)
        self.composite = composite.to(self.device).eval().requires_grad_(False)
        n = sum(p.numel() for p in composite.gpt.parameters())
        self.logger.info("GPT params: %.1fM", n / 1e6)
        return self.composite

    def load(self, path: str) -> None:
        """Load a port checkpoint: ``torch.save({"vqvae": ..., "gpt": ...})``."""
        state = torch.load(path, map_location="cpu", weights_only=True)
        self.composite.vqvae.load_state_dict(state["vqvae"], strict=True)
        self.composite.gpt.load_state_dict(state["gpt"], strict=True)
        self.logger.info("restored %s", path)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.no_grad()
    def generate_images(self, val_loader=None, n_samples: int = 16, epoch: int = 0,
                        temperature: float = 1.0, top_k: int = 100
                        ) -> Dict[str, object]:
        """Sample ``n_samples`` x seq_len tokens, decode them to NHWC images and
        write ``samples_epoch{epoch}.jpg`` to the run dir. ``val_loader`` is
        ignored, as in the JAX worker. Returns the tokens, the images and the
        seconds each phase took (the device is synchronised between phases)."""
        self._sync()
        t0 = time.perf_counter()
        tokens = self.composite.sample(n_samples, temperature=temperature, top_k=top_k,
                                       generator=self.generator, dtype=self.dtype)
        self._sync()
        t1 = time.perf_counter()
        images = self.composite.z_to_image(tokens)
        self._sync()
        t2 = time.perf_counter()
        grid = make_grid(to_uint8(images.float().cpu().numpy(), self.mean, self.std), nrow=4)
        path = os.path.join(self.run_dir, f"samples_epoch{epoch}.jpg")
        save_image(grid, path)
        self.logger.info("sampled %d x %d tokens in %.3f s, decoded in %.3f s -> %s",
                         n_samples, tokens.shape[1], t1 - t0, t2 - t1, path)
        return {"tokens": tokens, "images": images, "path": path,
                "seconds": {"sample": t1 - t0, "decode": t2 - t1}}

"""Stage-2 worker (PyTorch counterpart of the JAX ``train/vq_transformer_worker.py``).

This slice ports the serving side only: :meth:`init_state` (a seeded fresh
init), :meth:`load` (a port checkpoint) and :meth:`generate_images` (sample
tokens with the GPT prior, decode them with the frozen VQVAE, write a grid).
Training, AdamW and pkeep come with the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ..models.vq_transformer import VQTransformer
from .base import ServingWorker


class VQTransformerWorker(ServingWorker):
    composite: Optional[VQTransformer] = None

    def init_state(self) -> VQTransformer:
        """A fresh VQTransformer with weights drawn from a generator seeded by
        ``seed``, in eval mode on the worker's device. A stage-1 port
        checkpoint at ``architecture.vqvae.resume_path`` replaces the VQVAE."""
        composite = VQTransformer(self.config)
        gen = torch.Generator().manual_seed(self.seed)
        composite.vqvae.init_weights(gen)
        composite.gpt.init_weights(gen)
        self._restore_vqvae(composite.vqvae)
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

    @torch.no_grad()
    def generate_images(self, val_loader=None, n_samples: int = 16, epoch: int = 0,
                        temperature: float = 1.0, top_k: int = 100
                        ) -> Dict[str, object]:
        """Sample ``n_samples`` x seq_len tokens, decode them to NHWC images and
        write ``samples_epoch{epoch}.jpg`` to the run dir. ``val_loader`` is
        ignored, as in the JAX worker. Returns the tokens, the images and the
        seconds each phase took (the device is synchronised between phases)."""
        out = self._sample_and_decode(
            lambda: self.composite.sample(n_samples, temperature=temperature, top_k=top_k,
                                          generator=self.generator, dtype=self.dtype),
            self.composite.z_to_image, epoch)
        out["tokens"] = out.pop("codes")
        return out

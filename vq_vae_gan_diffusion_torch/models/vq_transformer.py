"""VQ-Transformer: frozen VQVAE + GPT prior over codebook indices (PyTorch
counterpart of the JAX ``models/vq_transformer.py``).

``encode_to_z`` and ``z_to_image`` take and return NHWC images, as the JAX
package's do. ``sample`` draws tokens after SOS (plus optional given
indices) through :func:`.mingpt.sample_tokens`. The training forward and
``log_images`` belong to the training slice and are not ported yet.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..config import Config, seq_len
from .mingpt import GPT, sample_tokens
from .vqvae import VQVAE


class VQTransformer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        model_name = cfg.architecture.model_name
        key = model_name if model_name in cfg.architecture else "vqvae_transformer"
        tcfg = cfg.architecture[key]
        self.sos_token = int(tcfg.sos_token)
        self.vocab_size = int(cfg.architecture.vqvae.num_codebook_vectors)
        self.vqvae = VQVAE.from_config(cfg)
        self.gpt = GPT(vocab_size=self.vocab_size, block_size=int(tcfg.block_size),
                       n_layer=int(tcfg.n_layer), n_head=int(tcfg.n_head),
                       n_embd=int(tcfg.n_embd))
        self.seq_len = seq_len(cfg)
        self.decode_quant = tcfg.get("decode_quant", None)

    @torch.no_grad()
    def encode_to_z(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """x [B, H, W, C] -> (z_q [B, h, w, D], indices [B, h*w])."""
        z_q, indices, _ = self.vqvae.encode(x)
        return z_q, indices.reshape(x.shape[0], -1)

    @torch.no_grad()
    def z_to_image(self, indices: torch.Tensor) -> torch.Tensor:
        """indices [B, h*w] -> images [B, H, W, C]."""
        return self.vqvae.decode_indices(indices)

    def sample(self, batch: int, start_indices: Optional[torch.Tensor] = None,
               steps: Optional[int] = None, temperature: float = 1.0, top_k: int = 100,
               generator: Optional[torch.Generator] = None, fused: bool = True,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """Sample ``steps`` (default seq_len) new indices after SOS [+ start_indices]."""
        device = self.gpt.pos_emb.device
        prefix = torch.full((batch, 1), self.sos_token, dtype=torch.long, device=device)
        if start_indices is not None:
            prefix = torch.cat([prefix, start_indices.to(device=device, dtype=torch.long)], 1)
        steps = steps if steps is not None else self.seq_len
        return sample_tokens(self.gpt, prefix, prefix.shape[1], steps, temperature,
                             top_k, fused=fused, quant=self.decode_quant, dtype=dtype,
                             generator=generator)

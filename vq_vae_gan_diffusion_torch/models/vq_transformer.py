"""VQ-Transformer: frozen VQVAE + GPT prior over codebook indices (PyTorch
counterpart of the JAX ``models/vq_transformer.py``).

``encode_to_z`` and ``z_to_image`` take and return NHWC images, as the JAX
package's do. ``sample`` draws tokens after SOS (plus optional given
indices) through :func:`.mingpt.sample_tokens`. The training forward
corrupts the frozen VQVAE's indices (each kept with probability ``pkeep``,
else replaced by a uniform random index), prepends SOS and returns the
GPT's logits for ``new_indices[:, :-1]`` with the *original* indices as
targets. ``log_images`` gives the rows of the training grid: the input, its
reconstruction, a completion of the first half of its indices and a full
sample, both samples through the fused decode route.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ..config import Config, seq_len
from ..parallel.mesh import draw_rows
from .mingpt import GPT, sample_tokens
from .vqvae import VQVAE


class VQTransformer(nn.Module):
    def __init__(self, cfg: Config):
        super().__init__()
        model_name = cfg.architecture.model_name
        key = model_name if model_name in cfg.architecture else "vqvae_transformer"
        tcfg = cfg.architecture[key]
        self.sos_token = int(tcfg.sos_token)
        self.pkeep = float(tcfg.pkeep)
        self.vocab_size = int(cfg.architecture.vqvae.num_codebook_vectors)
        self.vqvae = VQVAE.from_config(cfg)
        self.gpt = GPT(vocab_size=self.vocab_size, block_size=int(tcfg.block_size),
                       n_layer=int(tcfg.n_layer), n_head=int(tcfg.n_head),
                       n_embd=int(tcfg.n_embd), remat=bool(tcfg.get("remat", False)))
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

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None, *,
                keep: Optional[torch.Tensor] = None,
                random_indices: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Training forward: x [B, H, W, C] -> (logits [B, T, V], targets [B, T]).
        ``keep`` (1 keeps an index) and ``random_indices`` [B, T] are drawn
        from ``generator`` unless given (the tests hand in the JAX draws); under
        data parallelism, this rank's rows of the global batch's draws
        (:func:`..parallel.draw_rows`)."""
        _, indices = self.encode_to_z(x)
        b, t = indices.shape
        if keep is None:
            keep = draw_rows(lambda n: torch.bernoulli(
                torch.full((n, t), self.pkeep, device=indices.device), generator=generator), b)
        if random_indices is None:
            random_indices = draw_rows(lambda n: torch.randint(
                0, self.vocab_size, (n, t), generator=generator, device=indices.device), b)
        keep = keep.to(device=indices.device, dtype=indices.dtype)
        new_indices = keep * indices + (1 - keep) * random_indices.to(indices)
        sos = torch.full((b, 1), self.sos_token, dtype=indices.dtype, device=indices.device)
        new_indices = torch.cat([sos, new_indices], dim=1)
        return self.gpt(new_indices[:, :-1]), indices

    @torch.no_grad()
    def log_images(self, x: torch.Tensor, generator: Optional[torch.Generator] = None,
                   dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
        """The training grid's rows for x [B, H, W, C]: ``input``, ``rec``,
        ``half_sample`` (the first T // 2 indices given, the rest sampled)
        and ``full_sample``, as NHWC images. The GPT samples in eval mode, at
        compute type ``dtype``, and goes back to the mode it was in."""
        _, indices = self.encode_to_z(x)
        b, t = indices.shape
        half = indices[:, : t // 2]
        was_training = self.gpt.training
        self.gpt.eval()
        try:
            half_new = self.sample(b, start_indices=half, steps=t - t // 2, generator=generator,
                                   dtype=dtype)
            full = self.sample(b, steps=t, generator=generator, dtype=dtype)
        finally:
            self.gpt.train(was_training)
        return {"input": x, "rec": self.z_to_image(indices),
                "half_sample": self.z_to_image(torch.cat([half, half_new], dim=1)),
                "full_sample": self.z_to_image(full)}

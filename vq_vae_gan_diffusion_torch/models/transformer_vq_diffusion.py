"""Transformer-predictor VQ-Diffusion with AdaLN time conditioning, sampling
side (PyTorch counterpart of the JAX ``models/transformer_vq_diffusion.py``).

- :class:`TransformerPredictor`: token embedding plus a learned positional
  encoding, blocks of AdaLN(t) -> self-attention -> FFN, a head to K-1
  logits. Module names follow the flax module names (``embedding``,
  ``positional_encoding``, ``time_embedding``, ``block{i}.norm1``,
  ``.ada_ln_scale``, ``.ada_ln_bias``, ``.self_attention.{query,key,value,
  out}``, ``.norm2``, ``.ffn1``, ``.ffn2``, ``fc``), so
  ``weights.transformer_predictor_state_from_jax`` maps a JAX tree key for
  key.
- :class:`TransformerVQDiffusion`: the discrete mask-and-replace process
  with γ̄_T 0.9, mask-logit pad -30 and the ``"prior"`` chain init, and its
  samplers ``sample`` (every step) and ``fast_sample`` (every
  ``skip_step``-th step, truncated top-r Gumbel sampling).

Kept as in the JAX package: LayerNorm eps 1e-6 (flax's default, not
torch's 1e-5); the attention scales q by head_dim^-0.5 before the product;
a block returns ``norm2(h) + ffn``, not ``h + ffn``; the samplers clamp
indices to K-2 (never the mask class) and reshape to [B, g, g];
``fast_sample`` takes each step's posterior at t itself.

Dropout, the training loss, and text conditioning (it needs CLIP weights,
which the repository does not hold) are not ported; ``use_text_condition``
raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion.discrete import DiscreteDiffusion, log_onehot_to_index


class SelfAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` on one input, no mask."""

    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.query = nn.Linear(embed_dim, embed_dim)
        self.key = nn.Linear(embed_dim, embed_dim)
        self.value = nn.Linear(embed_dim, embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, c = x.shape
        h = self.num_heads
        q, k, v = (proj(x).view(b, n, h, c // h) for proj in (self.query, self.key, self.value))
        q = q / math.sqrt(c // h)
        att = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k), dim=-1)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, n, c))


class AdaLNTransformerBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.ada_ln_scale = nn.Linear(embed_dim, embed_dim)
        self.ada_ln_bias = nn.Linear(embed_dim, embed_dim)
        self.self_attention = SelfAttention(embed_dim, num_heads)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.ffn1 = nn.Linear(embed_dim, 4 * embed_dim)
        self.ffn2 = nn.Linear(4 * embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor) -> torch.Tensor:
        h = self.norm1(x)
        h = self.ada_ln_scale(t_emb)[:, None, :] * h + self.ada_ln_bias(t_emb)[:, None, :]
        h = h + self.self_attention(h)
        h2 = self.norm2(h)
        return h2 + self.ffn2(F.relu(self.ffn1(h2)))


class TransformerPredictor(nn.Module):
    def __init__(self, num_tokens: int, embedding_dim: int = 64, num_layers: int = 4,
                 num_heads: int = 4, seq_len: int = 256, diffusion_steps: int = 100):
        super().__init__()
        self.num_layers = num_layers
        self.embedding = nn.Embedding(num_tokens, embedding_dim)
        self.positional_encoding = nn.Parameter(torch.zeros(1, seq_len, embedding_dim))
        self.time_embedding = nn.Embedding(diffusion_steps, embedding_dim)
        for i in range(num_layers):
            self.add_module(f"block{i}", AdaLNTransformerBlock(embedding_dim, num_heads))
        self.fc = nn.Linear(embedding_dim, num_tokens - 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's (flax default) init, drawn from ``generator``:
        lecun-normal (truncated) dense kernels with zero biases, truncated
        N(0, 1/dim) embeddings, N(0, 1) positional encoding, LayerNorm 1, 0."""
        def trunc(w, fan):
            std = math.sqrt(1.0 / fan) / 0.87962566103423978
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
        for m in self.modules():
            if isinstance(m, nn.Linear):
                trunc(m.weight, m.in_features)
                nn.init.zeros_(m.bias)
            elif isinstance(m, nn.Embedding):
                trunc(m.weight, m.embedding_dim)
            elif isinstance(m, nn.LayerNorm):
                m.reset_parameters()
        nn.init.normal_(self.positional_encoding, 0.0, 1.0, generator=generator)

    def forward(self, indices: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        """indices [B, N] int, t [B] int -> logits [B, N, num_tokens - 1]."""
        x = self.embedding(indices.long()) + self.positional_encoding
        t_emb = self.time_embedding(t.long())
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, t_emb)
        return self.fc(x)


class TransformerVQDiffusion(nn.Module):
    """Discrete diffusion + TransformerPredictor; ``codebook_size`` codes
    and the mask class make K = codebook_size + 1 classes."""

    def __init__(self, codebook_size: int = 1024, seq_len: int = 256,
                 diffusion_steps: int = 100, embedding_dim: int = 64, num_layers: int = 4,
                 num_heads: int = 4, truncation_rate: float = 0.86,
                 use_text_condition: bool = False, fused_posterior=False):
        super().__init__()
        if use_text_condition:
            raise NotImplementedError(
                "use_text_condition needs a CLIP text encoder's weights, which the repository "
                "does not hold; see ROADMAP.md, slice 5 (discrete VQ-diffusion priors)")
        self.num_classes = codebook_size + 1
        self.seq_len = seq_len
        self.predictor = TransformerPredictor(self.num_classes, embedding_dim, num_layers,
                                              num_heads, seq_len, diffusion_steps)
        self.diffusion = DiscreteDiffusion(
            num_classes=self.num_classes, seq_len=seq_len, timesteps=diffusion_steps,
            ctt_T=0.9, mask_logit_pad=-30.0, chain_init="prior",
            truncation_rate=truncation_rate)
        self.diffusion.fused_posterior = fused_posterior

    def _bind(self):
        """Binds the index-native denoiser (every structured step) and returns
        the dense one, which the chain-init step calls on its log-probs."""
        def model_fn_idx(indices, t):
            return self.predictor(indices, t)

        def model_fn(log_x_t, t):
            return model_fn_idx(log_onehot_to_index(log_x_t), t)

        self.diffusion.model_fn_idx = model_fn_idx
        return model_fn

    def _device(self) -> torch.device:
        return self.predictor.fc.weight.device

    def _grid(self, idx: torch.Tensor) -> torch.Tensor:
        g = int(self.seq_len ** 0.5)
        return idx.clamp(max=self.num_classes - 2).reshape(idx.shape[0], g, g)

    @torch.no_grad()
    def sample(self, num_samples: int, generator: Optional[torch.Generator] = None,
               step_gumbel: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Every reverse step, t = T-1 .. 0 -> indices [B, g, g]. Noise from
        ``generator`` or injected as ``step_gumbel``, one [B, N, K] tensor a
        step."""
        self.diffusion.model_fn = self._bind()
        idx = self.diffusion.sample(num_samples, generator=generator, device=self._device(),
                                    step_gumbel=step_gumbel)
        return self._grid(idx)

    @torch.no_grad()
    def fast_sample(self, num_samples: int, skip_step: int = 4,
                    generator: Optional[torch.Generator] = None,
                    step_gumbel: Optional[Sequence[torch.Tensor]] = None) -> torch.Tensor:
        """Steps t = T-1, T-1-skip, ..., each posterior at t, with truncated
        top-r sampling -> indices [B, g, g]. Noise as in :meth:`sample`."""
        d = self.diffusion
        d.model_fn = self._bind()
        device = self._device()
        shape = (num_samples, self.seq_len, self.num_classes)
        seeds = d.posterior_route() == "prng"
        steps = np.arange(d.num_timesteps - 1, -1, -skip_step)
        log_z = d._chain_init(num_samples, None, device)
        t0 = torch.full((num_samples,), int(steps[0]), dtype=torch.long, device=device)
        z_idx = d.sample_categorical_truncated_idx(
            d.p_pred(log_z, t0), d._noise(0, shape, step_gumbel, generator, device))
        for i, step in enumerate(steps[1:], start=1):
            t = torch.full((num_samples,), int(step), dtype=torch.long, device=device)
            z_idx = d._step_idx(z_idx, t, t, d._noise(i, shape, step_gumbel, generator, device,
                                                      seeds), truncated=True)
        return self._grid(z_idx)

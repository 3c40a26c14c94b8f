"""Transformer-predictor VQ-Diffusion with AdaLN time conditioning
(PyTorch counterpart of the JAX ``models/transformer_vq_diffusion.py``).

- :class:`TransformerPredictor`: token embedding plus a learned positional
  encoding, blocks of AdaLN(t) -> self-attention -> FFN, a head to K-1
  logits. Module names follow the flax module names (``embedding``,
  ``positional_encoding``, ``time_embedding``, ``block{i}.norm1``,
  ``.ada_ln_scale``, ``.ada_ln_bias``, ``.self_attention.{query,key,value,
  out}``, ``.norm_cross``, ``.cross_attention.{query,key,value,out}``,
  ``.norm2``, ``.ffn1``, ``.ffn2``, ``fc``), so
  ``weights.transformer_predictor_state_from_jax`` maps a JAX tree key for
  key.
- :class:`TransformerVQDiffusion`: the discrete mask-and-replace process
  with γ̄_T 0.9, mask-logit pad -30, mask weights (1.5, 1.0), the auxiliary
  x0-KL at 5e-4 with its adaptive weight, uniform t and the ``"prior"``
  chain init; its training ``loss`` and its samplers ``sample`` (every
  step) and ``fast_sample`` (every ``skip_step``-th step, truncated top-r
  Gumbel sampling).

Kept as in the JAX package: LayerNorm eps 1e-6 (flax's default, not
torch's 1e-5); the attention scales q by head_dim^-0.5 before the product;
the cross-attention's residual is its normed input, ``norm_cross(h) +
xattn``;
a block returns ``norm2(h) + ffn``, not ``h + ffn``; the samplers clamp
indices to K-2 (never the mask class) and reshape to [B, g, g];
``fast_sample`` takes each step's posterior at t itself.

Dropout (0.1, as the flax blocks' default) acts in train mode, as flax's
does when the loss gives it a dropout key: on the attention weights, one
mask broadcast over the batch and the heads, and on the attention's and
the FFN's outputs; its masks come from torch's global generator. ``loss``
runs the predictor in train mode, the samplers in eval mode (the JAX
samplers' ``deterministic=True``).

Text conditioning (``use_text_condition``) builds each block's
``norm_cross`` and ``cross_attention`` (key and value from ``cond_dim``,
CLIP ViT-B/32's 512 by default), which run on a ``cond_emb`` [B, S,
D_c] the caller gives :meth:`TransformerVQDiffusion.loss`, ``sample`` and
``fast_sample``, as the JAX methods take it; with ``cond_emb`` None the
blocks skip them, as the JAX block's ``if`` does. ``encode_text`` needs
CLIP weights, which the repository does not hold, and raises.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..diffusion.discrete import DiscreteDiffusion, LtState, log_onehot_to_index
from ..utils import tracing
from .blocks import at_least_f32

DROPOUT = 0.1          # the flax blocks' default, read when a block is built
CLIP_TEXT_DIM = 512    # CLIP ViT-B/32's text states, the JAX encode_text's cond_emb width


class Attention(nn.Module):
    """flax ``MultiHeadDotProductAttention``, no mask: the query projected
    from ``x`` [B, N, C], the key and value from ``ctx`` [B, S, kv_dim]
    (``x`` itself when None) to C, ``out`` back to C; the softmax in f32."""

    def __init__(self, embed_dim: int, num_heads: int, kv_dim: Optional[int] = None):
        super().__init__()
        self.num_heads = num_heads
        self.dropout = DROPOUT
        self.query = nn.Linear(embed_dim, embed_dim)
        self.key = nn.Linear(kv_dim or embed_dim, embed_dim)
        self.value = nn.Linear(kv_dim or embed_dim, embed_dim)
        self.out = nn.Linear(embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, ctx: Optional[torch.Tensor] = None) -> torch.Tensor:
        ctx = x if ctx is None else ctx
        (b, n, c), s, h = x.shape, ctx.shape[1], self.num_heads
        q = self.query(x).view(b, n, h, c // h) / math.sqrt(c // h)
        k, v = (proj(ctx).view(b, s, h, c // h) for proj in (self.key, self.value))
        sim = torch.einsum("bqhd,bkhd->bhqk", q, k)
        att = torch.softmax(at_least_f32(sim), dim=-1).to(v.dtype)
        if self.training and self.dropout > 0:
            keep = 1.0 - self.dropout
            mask = torch.bernoulli(torch.full((1, 1, n, s), keep, device=x.device))
            att = att * (mask / keep).to(att.dtype)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", att, v).reshape(b, n, c))


class AdaLNTransformerBlock(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, cond_dim: Optional[int] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.ada_ln_scale = nn.Linear(embed_dim, embed_dim)
        self.ada_ln_bias = nn.Linear(embed_dim, embed_dim)
        self.self_attention = Attention(embed_dim, num_heads)
        self.drop = nn.Dropout(DROPOUT)
        if cond_dim is not None:
            self.norm_cross = nn.LayerNorm(embed_dim, eps=1e-6)
            self.cross_attention = Attention(embed_dim, num_heads, cond_dim)
        self.norm2 = nn.LayerNorm(embed_dim, eps=1e-6)
        self.ffn1 = nn.Linear(embed_dim, 4 * embed_dim)
        self.ffn2 = nn.Linear(4 * embed_dim, embed_dim)

    def forward(self, x: torch.Tensor, t_emb: torch.Tensor,
                cond_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.norm1(x)
        h = self.ada_ln_scale(t_emb)[:, None, :] * h + self.ada_ln_bias(t_emb)[:, None, :]
        h = h + self.drop(self.self_attention(h))
        if cond_emb is not None and hasattr(self, "cross_attention"):
            hn = self.norm_cross(h)
            # the residual is the normed input, as the JAX block adds it
            h = hn + self.drop(self.cross_attention(hn, cond_emb))
        h2 = self.norm2(h)
        return h2 + self.drop(self.ffn2(F.relu(self.ffn1(h2))))


class TransformerPredictor(nn.Module):
    def __init__(self, num_tokens: int, embedding_dim: int = 64, num_layers: int = 4,
                 num_heads: int = 4, seq_len: int = 256, diffusion_steps: int = 100,
                 cond_dim: Optional[int] = None):
        super().__init__()
        self.num_layers = num_layers
        self.embedding = nn.Embedding(num_tokens, embedding_dim)
        self.positional_encoding = nn.Parameter(torch.zeros(1, seq_len, embedding_dim))
        self.time_embedding = nn.Embedding(diffusion_steps, embedding_dim)
        for i in range(num_layers):
            self.add_module(f"block{i}", AdaLNTransformerBlock(embedding_dim, num_heads,
                                                                cond_dim))
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

    def forward(self, indices: torch.Tensor, t: torch.Tensor,
                cond_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """indices [B, N] int, t [B] int, ``cond_emb`` [B, S, D_c] or None ->
        logits [B, N, num_tokens - 1]. The blocks' cross-attention runs
        only when it was built and ``cond_emb`` is given, as the JAX
        block's ``if``."""
        x = self.embedding(indices.long()) + self.positional_encoding
        t_emb = self.time_embedding(t.long())
        for i in range(self.num_layers):
            x = getattr(self, f"block{i}")(x, t_emb, cond_emb)
        return self.fc(x)


class TransformerVQDiffusion(nn.Module):
    """Discrete diffusion + TransformerPredictor; ``codebook_size`` codes
    and the mask class make K = codebook_size + 1 classes."""

    def __init__(self, codebook_size: int = 1024, seq_len: int = 256,
                 diffusion_steps: int = 100, embedding_dim: int = 64, num_layers: int = 4,
                 num_heads: int = 4, truncation_rate: float = 0.86,
                 use_text_condition: bool = False, fused_posterior=False,
                 cond_dim: Optional[int] = None):
        super().__init__()
        self.num_classes = codebook_size + 1
        self.seq_len = seq_len
        self.use_text_condition = use_text_condition
        self.predictor = TransformerPredictor(
            self.num_classes, embedding_dim, num_layers, num_heads, seq_len, diffusion_steps,
            (cond_dim or CLIP_TEXT_DIM) if use_text_condition else None)
        self.diffusion = DiscreteDiffusion(
            num_classes=self.num_classes, seq_len=seq_len, timesteps=diffusion_steps,
            auxiliary_loss_weight=5e-4, adaptive_auxiliary_loss=True, mask_weight=(1.5, 1.0),
            ctt_T=0.9, mask_logit_pad=-30.0, chain_init="prior",
            use_importance_sampling=False, truncation_rate=truncation_rate)
        self.diffusion.fused_posterior = fused_posterior

    def _bind(self, cond_emb: Optional[torch.Tensor] = None):
        """Binds the index-native denoiser (every structured step) and returns
        the dense one, which the chain-init step calls on its log-probs; both
        close over ``cond_emb``."""
        def model_fn_idx(indices, t):
            return self.predictor(indices, t, cond_emb)

        def model_fn(log_x_t, t):
            return model_fn_idx(log_onehot_to_index(log_x_t), t)

        self.diffusion.model_fn_idx = model_fn_idx
        return model_fn

    def encode_text(self, texts: Sequence[str]) -> Optional[torch.Tensor]:
        """CLIP ViT-B/32 text states for ``texts``, None without text
        conditioning. The repository holds no CLIP weights and nothing can be
        fetched, so with text conditioning on this raises; the caller passes
        its own ``cond_emb`` [B, S, D_c] to :meth:`loss` and the samplers."""
        if not self.use_text_condition:
            return None
        raise NotImplementedError(
            "encode_text needs the CLIP text encoder openai/clip-vit-base-patch32 (tokenizer and "
            "weights), which the repository does not hold; pass cond_emb [B, S, D_c] instead")

    def _device(self) -> torch.device:
        return self.predictor.fc.weight.device

    def init_lt_state(self) -> LtState:
        return LtState.init(self.diffusion.num_timesteps, device=self._device())

    def loss(self, x0: torch.Tensor, lt: LtState, generator: Optional[torch.Generator] = None,
             *, t: Optional[torch.Tensor] = None, gumbel: Optional[torch.Tensor] = None,
             cond_emb: Optional[torch.Tensor] = None):
        """The training loss of indices x0 [B, N] with the predictor in train
        mode (dropout on) -> (loss, metrics, the new ``LtState``): t uniform,
        ``DiscreteDiffusion.train_loss``'s draws from ``generator`` unless
        given; ``cond_emb`` [B, S, D_c] for the cross-attention."""
        self.predictor.train()
        self.diffusion.model_fn = self._bind(cond_emb)
        return self.diffusion.train_loss(x0, lt, generator, t=t, gumbel=gumbel)

    def _grid(self, idx: torch.Tensor) -> torch.Tensor:
        g = int(self.seq_len ** 0.5)
        return idx.clamp(max=self.num_classes - 2).reshape(idx.shape[0], g, g)

    @torch.no_grad()
    def sample(self, num_samples: int, generator: Optional[torch.Generator] = None,
               step_gumbel: Optional[Sequence[torch.Tensor]] = None,
               cond_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Every reverse step, t = T-1 .. 0 -> indices [B, g, g]. Noise from
        ``generator`` or injected as ``step_gumbel``, one [B, N, K] tensor a
        step; ``cond_emb`` [B, S, D_c] for the cross-attention."""
        self.predictor.eval()
        self.diffusion.model_fn = self._bind(cond_emb)
        idx = self.diffusion.sample(num_samples, generator=generator, device=self._device(),
                                    step_gumbel=step_gumbel)
        return self._grid(idx)

    @torch.no_grad()
    def fast_sample(self, num_samples: int, skip_step: int = 4,
                    generator: Optional[torch.Generator] = None,
                    step_gumbel: Optional[Sequence[torch.Tensor]] = None,
                    cond_emb: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Steps t = T-1, T-1-skip, ..., each posterior at t, with truncated
        top-r sampling -> indices [B, g, g]. Noise and ``cond_emb`` as in
        :meth:`sample`."""
        d = self.diffusion
        self.predictor.eval()
        d.model_fn = self._bind(cond_emb)
        device = self._device()
        shape = (num_samples, self.seq_len, self.num_classes)
        seeds = d.posterior_route() == "prng"
        steps = np.arange(d.num_timesteps - 1, -1, -skip_step)
        log_z = d._chain_init(num_samples, None, device)
        t0 = torch.full((num_samples,), int(steps[0]), dtype=torch.long, device=device)
        with tracing.span("discrete.chain"):
            with tracing.span("discrete.step"):
                z_idx = d.sample_categorical_truncated_idx(
                    d.p_pred(log_z, t0), d._noise(0, shape, step_gumbel, generator, device))
            for i, step in enumerate(steps[1:], start=1):
                with tracing.span("discrete.step"):
                    t = torch.full((num_samples,), int(step), dtype=torch.long, device=device)
                    z_idx = d._step_idx(z_idx, t, t, d._noise(i, shape, step_gumbel, generator,
                                                              device, seeds), truncated=True)
        return self._grid(z_idx)

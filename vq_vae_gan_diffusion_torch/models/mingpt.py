"""minGPT-style causal transformer (PyTorch counterpart of the JAX ``models/mingpt.py``).

Learned positional embedding [1, block_size, n_embd], pre-LN blocks (LN eps
1e-5) with separate q/k/v projections and an exact-erf GELU MLP, a bias-free
vocab head, N(0, 0.02) init. Module names reproduce the reference
``state_dict`` keys (``blocks.{i}.attn.query``, ``blocks.{i}.mlp.0``,
``blocks.{i}.attn.mask``, ...). No dropout: the JAX package builds its GPT
with every rate at 0.0. The training forward is :meth:`GPT.forward` over the
whole sequence, its causal attention plain products as in the JAX package;
``remat`` recomputes each block's activations in the backward
(``torch.utils.checkpoint``), as the JAX module's ``nn.remat``;
``act_sharding`` runs it over a rank's share of the tokens (sequence
parallelism, :mod:`..parallel.sequence`).

Sampling (:func:`sample_tokens`) is a host loop over positions with a Python
int ``t``; it reads nothing back from the device per token. Its default route
runs each position through :func:`..ops.gpt_decode.fused_decode_stack` -- the
CUDA kernel for CUDA tensors -- or, under ``quant``, its int8/int4-weight
counterparts :func:`..ops.gpt_decode.fused_decode_stack_q` and, with an int8
KV cache, :func:`..ops.gpt_decode.fused_decode_stack_qkv`. ``fused=False``
runs the module's own :meth:`GPT.decode_step` instead.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.gpt_decode import (QUANT_MODES, fused_decode_stack, fused_decode_stack_q,
                              fused_decode_stack_qkv, pack_decode_params)
from ..utils import tracing
from .blocks import at_least_f32

KVCache = List[Tuple[torch.Tensor, torch.Tensor]]


class CausalSelfAttention(nn.Module):
    def __init__(self, n_head: int, n_embd: int, block_size: int):
        super().__init__()
        self.n_head = n_head
        self.query = nn.Linear(n_embd, n_embd)
        self.key = nn.Linear(n_embd, n_embd)
        self.value = nn.Linear(n_embd, n_embd)
        self.proj = nn.Linear(n_embd, n_embd)
        mask = torch.tril(torch.ones(block_size, block_size))
        self.register_buffer("mask", mask.reshape(1, 1, block_size, block_size))

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        return x.reshape(b, t, self.n_head, c // self.n_head).transpose(1, 2)

    def forward(self, x: torch.Tensor, seq: Optional[tuple] = None) -> torch.Tensor:
        """x [B, T, C] -> [B, T, C]. Under tensor parallelism q, k and v hold
        this rank's ``n_head`` heads (the local count) and ``proj`` takes
        their concatenation, its input's shard. Under sequence parallelism
        ``seq`` is (the ``model`` group, the first token's position): x
        holds this rank's tokens, whose queries attend to the keys and
        values gathered over the group, the causal mask offset by that
        position."""
        b, t, _ = x.shape
        q, k, v = self._heads(self.query(x)), self._heads(self.key(x)), self._heads(self.value(x))
        start = 0
        if seq is not None:
            from ..parallel.sequence import gather_tokens

            group, start = seq
            k, v = gather_tokens(torch.cat([k, v], dim=-1), group, dim=2).chunk(2, dim=-1)
        att = (q @ k.transpose(-2, -1)) * q.shape[-1] ** -0.5
        att = att.masked_fill(self.mask[:, :, start:start + t, :k.shape[2]] == 0, float("-inf"))
        y = torch.softmax(at_least_f32(att), dim=-1).to(v.dtype) @ v   # [B, H, T, D]
        return self.proj(y.transpose(1, 2).reshape(b, t, -1))

    def decode_step(self, x: torch.Tensor, pos: int,
                    cache: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
        """One token x [B, 1, C] against a [B, H, N, D] cache, written in place
        at row ``pos``."""
        b, _, c = x.shape
        k_cache, v_cache = cache
        q = self._heads(self.query(x))                            # [B, H, 1, D]
        k_cache[:, :, pos] = self._heads(self.key(x))[:, :, 0]
        v_cache[:, :, pos] = self._heads(self.value(x))[:, :, 0]
        att = (q @ k_cache.transpose(-2, -1)) * (c // self.n_head) ** -0.5
        valid = torch.arange(k_cache.shape[2], device=x.device) <= pos
        att = att.masked_fill(~valid, float("-inf"))
        y = torch.softmax(at_least_f32(att), dim=-1).to(v_cache.dtype) @ v_cache
        return self.proj(y.transpose(1, 2).reshape(b, 1, c))


class Block(nn.Module):
    def __init__(self, n_head: int, n_embd: int, block_size: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(n_embd, eps=1e-5)
        self.ln2 = nn.LayerNorm(n_embd, eps=1e-5)
        self.attn = CausalSelfAttention(n_head, n_embd, block_size)
        self.mlp = nn.Sequential(nn.Linear(n_embd, 4 * n_embd), nn.GELU(),
                                 nn.Linear(4 * n_embd, n_embd))

    def forward(self, x: torch.Tensor, seq: Optional[tuple] = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), seq)
        return x + self.mlp(self.ln2(x))

    def decode_step(self, x, pos, cache):
        x = x + self.attn.decode_step(self.ln1(x), pos, cache)
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """``act_sharding``: None, or the ``('data', 'model')`` mesh of
    :func:`..parallel.create_mesh` for sequence parallelism (the JAX
    module's ``act_sharding``, :mod:`..parallel.sequence`): ``forward``
    then keeps this rank's data rows and its tokens ``[r T / mp, (r + 1) T
    / mp)`` through every block, gathers each attention's keys and values
    over ``model`` and returns the gathered logits [B / data, T, vocab].
    Sharded by ``tp`` (:func:`..parallel.shard_gpt`), the GPT is
    Megatron-SP: the parallel layers move the sequence, and ``forward``
    embeds the rank's tokens and runs no gather of its own. Decoding
    ignores it, as in JAX."""

    def __init__(self, vocab_size: int = 1024, block_size: int = 512,
                 n_layer: int = 12, n_head: int = 8, n_embd: int = 256, remat: bool = False,
                 act_sharding=None):
        super().__init__()
        self.vocab_size, self.block_size, self.remat = vocab_size, block_size, remat
        self.act_sharding = act_sharding
        self.n_layer, self.n_head, self.n_embd = n_layer, n_head, n_embd
        self.tok_emb = nn.Embedding(vocab_size, n_embd)
        self.pos_emb = nn.Parameter(torch.zeros(1, block_size, n_embd))
        self.blocks = nn.ModuleList(Block(n_head, n_embd, block_size)
                                    for _ in range(n_layer))
        self.ln_f = nn.LayerNorm(n_embd, eps=1e-5)
        self.head = nn.Linear(n_embd, vocab_size, bias=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """N(0, 0.02) for linear and embedding weights, drawn from
        ``generator``; zero biases and positional embedding; unit LN scales."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                nn.init.normal_(m.weight, 0.0, 0.02, generator=generator)
                if getattr(m, "bias", None) is not None:
                    nn.init.zeros_(m.bias)
            elif isinstance(m, nn.LayerNorm):
                nn.init.ones_(m.weight)
                nn.init.zeros_(m.bias)
        nn.init.zeros_(self.pos_emb)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        """idx [B, T] -> logits [B, T, vocab] (under ``act_sharding``, of this
        rank's data rows)."""
        t = idx.shape[1]
        if t > self.block_size:
            raise ValueError(f"sequence length {t} exceeds block size {self.block_size}")
        mesh, seq, start = self.act_sharding, None, 0
        if mesh is not None:
            from torch.distributed.tensor import DTensor

            from ..parallel.mesh import MODEL_AXIS, shard_batch

            mp = mesh.size(1)
            if t % mp != 0:
                raise ValueError(f"sequence length {t} not divisible by model_parallel={mp}")
            group, start = mesh.get_group(MODEL_AXIS), mesh.get_local_rank(MODEL_AXIS) * t // mp
            t = t // mp
            idx = shard_batch(idx, mesh)[:, start:start + t]
            if not isinstance(self.head.weight, DTensor):   # else tensor parallel gathers
                seq = (group, start)
        x = self.tok_emb(idx) + self.pos_emb[:, start:start + t]
        remat = self.remat and torch.is_grad_enabled()
        for block in self.blocks:
            x = checkpoint(block, x, seq, use_reentrant=False) if remat else block(x, seq)
        logits = self.head(self.ln_f(x))
        if seq is None:
            return logits
        from ..parallel.sequence import gather_logits

        return gather_logits(logits, seq[0], dim=1)

    # -- KV-cache decoding -------------------------------------------------
    def init_cache(self, batch: int, length: Optional[int] = None) -> KVCache:
        """Per-layer (k, v) caches [B, H, length, D], zero-filled, on the
        model's device."""
        n = int(length or self.block_size)
        d = self.n_embd // self.n_head
        p = self.pos_emb
        return [(p.new_zeros(batch, self.n_head, n, d), p.new_zeros(batch, self.n_head, n, d))
                for _ in range(self.n_layer)]

    def decode_step(self, token: torch.Tensor, pos: int, cache: KVCache) -> torch.Tensor:
        """token [B], pos int -> logits [B, vocab]; writes row ``pos`` of the cache."""
        x = self.tok_emb(token[:, None]) + self.pos_emb[:, pos:pos + 1]
        for block, layer_cache in zip(self.blocks, cache):
            x = block.decode_step(x, pos, layer_cache)
        return self.head(self.ln_f(x))[:, 0]


def top_k_filter(logits: torch.Tensor, k: int) -> torch.Tensor:
    """Keep the entries >= the k-th largest, set the rest to -inf (ties at the
    k-th value are all kept, as in the JAX package)."""
    k = min(k, logits.shape[-1])
    kth = torch.topk(logits, k, dim=-1).values[..., -1:]
    return logits.masked_fill(logits < kth, float("-inf"))


def categorical(logits: torch.Tensor, generator: Optional[torch.Generator],
                uniform: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One draw per row from softmax(logits) by the Gumbel-max trick (as
    ``jax.random.categorical``) on ``uniform`` (default: drawn from
    ``generator``); no host synchronisation."""
    u = uniform if uniform is not None else torch.rand(logits.shape, generator=generator,
                                                       device=logits.device)
    u = u.clamp_min(torch.finfo(u.dtype).tiny)
    return torch.argmax(logits - torch.log(-torch.log(u)), dim=-1)


@torch.no_grad()
def sample_tokens(gpt: GPT, prefix: torch.Tensor, prefix_len: int, steps: int,
                  temperature: float = 1.0, top_k: Optional[int] = 100,
                  fused: bool = True, quant: Optional[str] = None,
                  dtype: torch.dtype = torch.float32,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """KV-cached autoregressive sampling.

    Args:
      prefix: [B, L0] given tokens (SOS + optional partial indices), on the
        model's device.
      prefix_len: number of given tokens; positions before it are teacher-forced.
      steps: number of tokens to generate.
      fused: True runs each position through :func:`fused_decode_stack` (the
        CUDA kernel on the card); False runs :meth:`GPT.decode_step`.
      quant: the fused route's weight streaming, as the JAX package's
        ``decode_quant``: None (weights in ``dtype``), ``int8`` (per-output-
        channel int8), ``int4`` (group-wise nibble-packed int4), or
        ``int8kv``/``int4kv``, which add an int8 KV cache with per-row
        scales. Embeddings, LN affines, biases and the head stay full
        precision. As in the JAX package, quant only takes effect on the
        fused route: ``fused=False`` runs the float module whatever it says.
      dtype: the fused route's compute type (float32 or bfloat16), which is
        also the weight and cache type where they are not quantized; the
        ``fused=False`` route runs in float32.
      generator: the torch.Generator of the sampling noise, on the device.

    Returns [B, steps] int64 tokens.
    """
    if quant not in QUANT_MODES:
        raise ValueError(f"unsupported quant mode {quant!r}")
    if not fused and dtype != torch.float32:
        raise ValueError("the fused=False route runs in float32 only")
    with tracing.span("gpt.sample"):
        b = prefix.shape[0]
        total = min(prefix_len + steps - 1, gpt.block_size)
        if fused:
            step = fused_step(gpt, b, total, temperature, dtype, quant)
        else:
            cache = gpt.init_cache(b, total)
            step = lambda token, t: gpt.decode_step(token, t, cache).float() / temperature
        out = []
        token = prefix[:, 0]
        for t in range(total):
            with tracing.span("gpt.position"):
                token_in = prefix[:, t] if t < prefix_len else token
                logits = step(token_in, t)
                if top_k is not None:
                    logits = top_k_filter(logits, top_k)
                token = categorical(logits, generator)
                if t >= prefix_len - 1:
                    out.append(token)
        return torch.stack(out, dim=1)


def fused_step(gpt: GPT, b: int, total: int, temperature: float = 1.0,
               dtype: torch.dtype = torch.float32, quant: Optional[str] = None):
    """The per-position function of :func:`sample_tokens`'s fused route, for
    ``b`` rows and ``total`` positions: ``step(token [B], t)`` embeds, runs
    the decode stack, commits the new cache rows (and, for an int8 cache,
    their scales) at row t, and returns the logits / temperature [B, vocab].
    Call it for t = 0, 1, ... in order; feeding it a given sequence
    teacher-forces it."""
    packed = pack_decode_params(gpt, dtype, quant)
    tok_emb = gpt.tok_emb.weight.float()
    pos_emb = gpt.pos_emb[0].float()
    w_head = gpt.head.weight.to(dtype).float()
    c = gpt.n_embd
    quant_kv = quant in ("int8kv", "int4kv")
    kv = torch.zeros((gpt.n_layer, b, total, 2 * c), dtype=torch.int8 if quant_kv else dtype,
                     device=tok_emb.device)
    kv_sc = torch.ones((gpt.n_layer, b, total, 2), device=tok_emb.device) if quant_kv else None

    def step(token: torch.Tensor, t: int) -> torch.Tensor:
        x = tok_emb[token] + pos_emb[t]
        if quant_kv:
            h, kv_new, sc_new = fused_decode_stack_qkv(x, packed, kv, kv_sc, t, n_head=gpt.n_head,
                                                       compute_dtype=dtype)
            kv_sc[:, :, t] = sc_new
        elif quant:
            h, kv_new = fused_decode_stack_q(x, packed, kv, t, n_head=gpt.n_head)
        else:
            h, kv_new = fused_decode_stack(x, packed, kv, t, n_head=gpt.n_head)
        kv[:, :, t] = kv_new      # the caller commits the new rows, in place
        hn = F.layer_norm(h, (c,), gpt.ln_f.weight, gpt.ln_f.bias, eps=1e-5)
        return (hn.to(dtype).float() @ w_head.T) / temperature

    return step

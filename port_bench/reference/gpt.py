"""The minGPT prior of the reference repository: learned positions, pre-LN
blocks (LayerNorm eps 1e-5) of causal multi-head attention with separate
query, key and value projections and a 4x MLP with the exact-erf GELU, a
final LayerNorm and a bias-free head. Float32, the whole sequence at once,
no cache: the plain function that the port's decode kernel computes one
position at a time."""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class Attention(nn.Module):
    def __init__(self, n_head: int, c: int):
        super().__init__()
        self.n_head = n_head
        self.query, self.key, self.value, self.proj = (nn.Linear(c, c) for _ in range(4))

    def forward(self, x):
        b, t, c = x.shape
        h = self.n_head

        def heads(y):
            return y.reshape(b, t, h, c // h).transpose(1, 2)
        q, k, v = heads(self.query(x)), heads(self.key(x)), heads(self.value(x))
        att = (q @ k.transpose(-2, -1)) * (c // h) ** -0.5
        mask = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
        att = torch.softmax(att.masked_fill(~mask, float("-inf")), dim=-1)
        return self.proj((att @ v).transpose(1, 2).reshape(b, t, c))


class Block(nn.Module):
    def __init__(self, n_head: int, c: int):
        super().__init__()
        self.ln1, self.ln2 = nn.LayerNorm(c, eps=1e-5), nn.LayerNorm(c, eps=1e-5)
        self.attn = Attention(n_head, c)
        self.mlp = nn.Sequential(nn.Linear(c, 4 * c), nn.GELU(), nn.Linear(4 * c, c))

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class GPT(nn.Module):
    """Weights under the port's names (``tok_emb``, ``pos_emb``,
    ``blocks.{i}.attn.query``, ``blocks.{i}.mlp.0``, ``ln_f``, ``head``)."""

    def __init__(self, vocab: int, block_size: int, n_layer: int, n_head: int, c: int):
        super().__init__()
        self.tok_emb = nn.Embedding(vocab, c)
        self.pos_emb = nn.Parameter(torch.zeros(1, block_size, c))
        self.blocks = nn.ModuleList(Block(n_head, c) for _ in range(n_layer))
        self.ln_f = nn.LayerNorm(c, eps=1e-5)
        self.head = nn.Linear(c, vocab, bias=False)

    def forward(self, idx: torch.Tensor) -> torch.Tensor:
        """Tokens [B, T] -> logits [B, T, vocab]."""
        x = self.tok_emb(idx) + self.pos_emb[:, :idx.shape[1]]
        for blk in self.blocks:
            x = blk(x)
        return self.head(self.ln_f(x))


def cross_entropy(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))

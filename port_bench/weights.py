"""Weights drawn on the device from the seed, the same for the program and
the plain reference, which carry the same parameter names.

Every floating parameter is drawn, in sorted name order, from three flat
tensors made in one call each by a ``torch.Generator`` on the device: a
standard normal, a normal truncated at two standard deviations, a uniform
on [-1, 1]. A rule maps each name to its kind and scale.
"""

from __future__ import annotations

import hashlib
import math
from typing import Callable, Dict, Tuple

import torch

Rule = Callable[[str, torch.Tensor], Tuple[str, float]]   # (kind, scale)


def derive(seed: int, *tags) -> int:
    """A 63-bit seed for the stream ``tags`` of the run seeded ``seed``."""
    digest = hashlib.sha256(repr((int(seed), *tags)).encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(device, seed: int, *tags) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(derive(seed, *tags))


def lecun(p: torch.Tensor) -> float:
    """flax's lecun-normal scale of a kernel: 1 / sqrt(fan in), widened for
    the truncation at two standard deviations."""
    return math.sqrt(1.0 / p[0].numel()) / 0.87962566103423978


@torch.no_grad()
def draw(params: Dict[str, torch.Tensor], rule: Rule, seed: int, tag: str) -> None:
    """Fill ``params`` (name -> tensor, all on one device) in place."""
    names = sorted(params)
    device = params[names[0]].device
    kinds = {n: rule(n, params[n]) for n in names}
    sizes = {k: sum(params[n].numel() for n in names if kinds[n][0] == k)
             for k in ("normal", "trunc", "uniform")}
    gen = generator(device, seed, "weights", tag)
    flat = {"normal": torch.randn(sizes["normal"], generator=gen, device=device),
            "uniform": torch.rand(sizes["uniform"], generator=gen, device=device) * 2 - 1}
    u = torch.rand(sizes["trunc"], generator=gen, device=device)
    lo = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    flat["trunc"] = torch.erfinv(2 * (lo + u * (1 - 2 * lo)) - 1).mul_(math.sqrt(2)).clamp_(-2, 2)
    offset = dict.fromkeys(flat, 0)
    for n in names:
        kind, scale = kinds[n]
        p = params[n]
        if kind in flat:
            k = p.numel()
            p.copy_(flat[kind][offset[kind]:offset[kind] + k].view_as(p) * scale)
            offset[kind] += k
        else:
            p.fill_(scale)           # "const"


def vqgan_rule(name: str, p: torch.Tensor) -> Tuple[str, float]:
    """Convolutions lecun-normal, the codebook U(-1/K, 1/K), biases 0,
    GroupNorm scales 1."""
    if name.endswith("codebook.weight"):
        return "uniform", 1.0 / p.shape[0]
    if p.dim() == 4:
        return "trunc", lecun(p)
    return "const", 1.0 if "group_norm.weight" in name or name.endswith("norm.weight") else 0.0


def gpt_rule(name: str, p: torch.Tensor) -> Tuple[str, float]:
    """minGPT's N(0, 0.02) for every matrix and embedding, the positional
    one included; biases 0, LayerNorm scales 1."""
    if p.dim() >= 2:
        return "normal", 0.02
    layer_norm = ".ln" in name or name.startswith("ln")
    return "const", 1.0 if layer_norm and name.endswith(".weight") else 0.0


def unet_rule(name: str, p: torch.Tensor) -> Tuple[str, float]:
    """flax's defaults: lecun-normal kernels, N(0, 1/dim) time embeddings,
    biases 0, BatchNorm scale 1 and shift 0."""
    if name == "time_embedding.weight":
        return "normal", p.shape[1] ** -0.5
    if p.dim() >= 2:
        return "trunc", lecun(p)
    bn_scale = p.dim() == 1 and name.endswith(".weight")
    return "const", 1.0 if bn_scale else 0.0

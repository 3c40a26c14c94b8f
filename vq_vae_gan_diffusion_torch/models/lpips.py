"""LPIPS perceptual distance on a VGG16 trunk (PyTorch counterpart of the
JAX ``models/lpips.py``).

The forward, as the JAX module's:

1. grey inputs repeat to RGB; both inputs shift and scale by the LPIPS
   constants;
2. five VGG16 stages of 3x3 convs and ReLUs, tapping each stage's last ReLU,
   with 2x2 max pools between stages that floor (28 -> 14 -> 7 -> 3 -> 1);
3. each tap unit-normalised over channels, eps 1e-10 outside the sqrt;
4. the squared difference weighted by ``|lin{i}|`` over channels, its
   spatial mean, summed over the taps -> [B, 1, 1, 1].

Inputs are NHWC, as the JAX module's. Parameter names follow the flax tree
(``vgg.conv{s}_{i}.weight|bias``, ``lin{i}``), so
``weights.lpips_state_from_jax`` maps a JAX tree key for key.

:func:`load_lpips` searches the explicit path, then ``$LPIPS_WEIGHTS``, then
``weights/lpips_vgg.npz``, and reads the ``.npz`` layout of
``tools/export_lpips_weights.py`` or a torch VGG16 ``.pth``. When nothing is
found it warns and draws a seeded random VGG from a ``torch.Generator``:
lecun-normal conv weights as flax draws them, zero biases, lin weights of
one. That is another draw than the JAX package's ``PRNGKey(42)`` (a
deliberate difference); parity tests transplant the JAX parameters instead.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .blocks import at_least_f32

log = logging.getLogger(__name__)

# (channels, convs) a stage; a tap after each stage's last ReLU
VGG16_STAGES = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
SHIFT = (-0.030, -0.088, -0.188)
SCALE = (0.458, 0.448, 0.450)


def conv_names():
    return [f"conv{s}_{i}" for s, (_, n) in enumerate(VGG16_STAGES) for i in range(n)]


class LPIPS(nn.Module):
    def __init__(self):
        super().__init__()
        convs, cin = {}, 3
        for s, (ch, n) in enumerate(VGG16_STAGES):
            for i in range(n):
                convs[f"conv{s}_{i}"] = nn.Conv2d(cin, ch, 3, padding=1)
                cin = ch
        self.vgg = nn.ModuleDict(convs)
        for i, (ch, _) in enumerate(VGG16_STAGES):
            self.register_parameter(f"lin{i}", nn.Parameter(torch.ones(ch)))
        self.register_buffer("shift", torch.tensor(SHIFT).view(1, 3, 1, 1), persistent=False)
        self.register_buffer("scale", torch.tensor(SCALE).view(1, 3, 1, 1), persistent=False)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """flax's default conv init from ``generator``: truncated-normal
        lecun (std sqrt(1/fan_in) / 0.8796, cut at two of it), zero biases;
        lin weights of one."""
        for conv in self.vgg.values():
            std = math.sqrt(1.0 / (conv.in_channels * 9)) / 0.87962566103423978
            nn.init.trunc_normal_(conv.weight, 0.0, std, -2 * std, 2 * std, generator=generator)
            nn.init.zeros_(conv.bias)
        for i in range(len(VGG16_STAGES)):
            nn.init.ones_(getattr(self, f"lin{i}"))

    def _taps(self, x: torch.Tensor):
        taps = []
        for s, (_, n) in enumerate(VGG16_STAGES):
            for i in range(n):
                x = F.relu(self.vgg[f"conv{s}_{i}"](x))
            taps.append(x)
            if s < len(VGG16_STAGES) - 1:
                x = F.max_pool2d(x, 2, 2)
        return taps

    def forward(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """x, y [B, H, W, C] (C 1 or 3) -> distance [B, 1, 1, 1]."""
        x, y = x.permute(0, 3, 1, 2), y.permute(0, 3, 1, 2)
        if x.shape[1] == 1:
            x, y = x.expand(-1, 3, -1, -1), y.expand(-1, 3, -1, -1)
        b = x.shape[0]
        # one trunk pass over both inputs
        taps = self._taps((torch.cat([x, y]) - self.shift) / self.scale)
        total = 0.0
        for i, t in enumerate(taps):
            tf = at_least_f32(t)
            t = t / (torch.sqrt((tf * tf).sum(1, keepdim=True)) + 1e-10).to(t.dtype)
            diff = (t[:b] - t[b:]) ** 2
            lin = torch.einsum("bchw,c->bhw", diff, getattr(self, f"lin{i}").abs())
            total = total + lin.mean((1, 2))
        return total.reshape(b, 1, 1, 1)


def lpips_state_from_npz(path: str) -> Dict[str, torch.Tensor]:
    """``.npz`` keys ``vgg/conv{s}_{i}/kernel|bias`` (HWIO) and ``lin{i}``."""
    from ..weights import lpips_state_from_jax

    params: Dict = {"vgg": {}}
    with np.load(path) as data:
        for key in data.files:
            if key.startswith("vgg/"):
                _, conv, leaf = key.split("/")
                params["vgg"].setdefault(conv, {})[leaf] = data[key]
            else:
                params[key] = data[key]
    return lpips_state_from_jax(params)


def lpips_state_from_torch(path: str) -> Dict[str, torch.Tensor]:
    """A torch VGG16 (+ lpips lin) state dict: the 13 conv weights in the
    order of their numeric keys, lin weights in key order (ones when none)."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    convs = sorted((k for k in sd if k.endswith(".weight") and sd[k].dim() == 4
                    and "lin" not in k),
                   key=lambda k: [int(t) for t in k[:-len(".weight")].split(".") if t.isdigit()])
    out: Dict[str, torch.Tensor] = {}
    for name, k in zip(conv_names(), convs):
        out[f"vgg.{name}.weight"] = sd[k].float()
        out[f"vgg.{name}.bias"] = sd[k[:-len("weight")] + "bias"].float()
    lins = sorted(k for k in sd if "lin" in k and k.endswith("weight"))
    for i, (ch, _) in enumerate(VGG16_STAGES):
        out[f"lin{i}"] = sd[lins[i]].float().reshape(-1) if lins else torch.ones(ch)
    return out


def load_lpips(path: Optional[str] = None, seed: int = 42) -> LPIPS:
    """An LPIPS with weights from the first of ``path``, ``$LPIPS_WEIGHTS``
    and ``weights/lpips_vgg.npz`` that exists (``.npz`` or ``.pth``/``.pt``),
    else a seeded random VGG with a warning. On the CPU, in eval mode, with
    no parameter requiring a gradient."""
    model = LPIPS()
    for cand in (path, os.environ.get("LPIPS_WEIGHTS"), os.path.join("weights", "lpips_vgg.npz")):
        if cand and os.path.exists(cand):
            if cand.endswith(".npz"):
                model.load_state_dict(lpips_state_from_npz(cand), strict=True)
                break
            if cand.endswith((".pth", ".pt")):
                model.load_state_dict(lpips_state_from_torch(cand), strict=True)
                break
    else:
        log.warning("LPIPS pretrained weights not found; using seeded random VGG features "
                    "(set $LPIPS_WEIGHTS for lpips-0.1.4 parity)")
        model.init_weights(torch.Generator().manual_seed(seed))
    return model.eval().requires_grad_(False)

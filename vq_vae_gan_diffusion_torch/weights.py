"""The JAX package's parameters -> the port's ``state_dict``s.

Takes the JAX package's parameter tree as a nested dict of numpy arrays and
returns ``{key: torch.Tensor}`` in the reference key layout that the port's
modules use, ready for ``load_state_dict(..., strict=True)``. The mapping
is this package's own copy:

- Dense kernels [in, out] -> Linear weights [out, in];
- Conv kernels HWIO -> OIHW;
- the port's GroupNorm keeps its affine under ``.group_norm``, the JAX
  package's under a nested ``GroupNorm_0``;
- minGPT's causal-mask buffer is regenerated from the positional-embedding
  length.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence

import numpy as np
import torch

from .config import Config, resolve_img_size

State = Dict[str, torch.Tensor]


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv(out: State, p: str, sub) -> None:
    out[f"{p}.weight"] = _t(np.transpose(np.asarray(sub["kernel"]), (3, 2, 0, 1)))
    if "bias" in sub:
        out[f"{p}.bias"] = _t(sub["bias"])


def _dense(out: State, p: str, sub) -> None:
    out[f"{p}.weight"] = _t(np.asarray(sub["kernel"]).T)
    if "bias" in sub:
        out[f"{p}.bias"] = _t(sub["bias"])


def _ln(out: State, p: str, sub) -> None:
    out[f"{p}.weight"] = _t(sub["scale"])
    out[f"{p}.bias"] = _t(sub["bias"])


def _gn(out: State, p: str, sub) -> None:
    inner = sub["GroupNorm_0"]
    out[f"{p}.group_norm.weight"] = _t(inner["scale"])
    out[f"{p}.group_norm.bias"] = _t(inner["bias"])


def _res_block(out: State, p: str, sub) -> None:
    _gn(out, f"{p}.block.0", sub["GroupNorm_0"])
    _conv(out, f"{p}.block.2", sub["conv1"])
    _gn(out, f"{p}.block.3", sub["GroupNorm_1"])
    _conv(out, f"{p}.block.6", sub["conv2"])
    if "shortcut" in sub:
        _conv(out, f"{p}.conv_shortcut", sub["shortcut"])


def _attn_block(out: State, p: str, sub) -> None:
    _gn(out, f"{p}.norm", sub["GroupNorm_0"])
    for src, dst in (("q", "q"), ("k", "k"), ("v", "v"), ("proj_out", "project_out")):
        _conv(out, f"{p}.{dst}", sub[src])


def _encoder(out: State, root: str, sub, *, img_size: int, interm: Sequence[int],
             n_res: int, attn_res: Sequence[int]) -> None:
    _conv(out, f"{root}.0", sub["conv_in"])
    i = 1
    channels = [interm[0], *interm]
    size = img_size
    for n in range(len(channels) - 1):
        for r in range(n_res):
            _res_block(out, f"{root}.{i}", sub[f"stage{n}_res{r}"]); i += 1
            if size in attn_res:
                _attn_block(out, f"{root}.{i}", sub[f"stage{n}_attn{r}"]); i += 1
        if n != len(channels) - 2:
            _conv(out, f"{root}.{i}.conv", sub[f"stage{n}_down"]["conv"]); i += 1
            size //= 2
    _res_block(out, f"{root}.{i}", sub["mid_res1"])
    _attn_block(out, f"{root}.{i + 1}", sub["mid_attn"])
    _res_block(out, f"{root}.{i + 2}", sub["mid_res2"])
    _gn(out, f"{root}.{i + 3}", sub["norm_out"])
    _conv(out, f"{root}.{i + 5}", sub["conv_out"])       # i + 4 is the Swish


def _decoder(out: State, root: str, sub, *, latent_size: int, interm: Sequence[int],
             n_res: int, attn_res: Sequence[int]) -> None:
    _conv(out, f"{root}.0", sub["conv_in"])
    _res_block(out, f"{root}.1", sub["mid_res1"])
    _attn_block(out, f"{root}.2", sub["mid_attn"])
    _res_block(out, f"{root}.3", sub["mid_res2"])
    i = 4
    size = latent_size
    for n in range(len(interm)):
        for r in range(n_res):
            _res_block(out, f"{root}.{i}", sub[f"stage{n}_res{r}"]); i += 1
            if size in attn_res:
                _attn_block(out, f"{root}.{i}", sub[f"stage{n}_attn{r}"]); i += 1
        if n != 0:
            _conv(out, f"{root}.{i}.conv", sub[f"stage{n}_up"]["conv"]); i += 1
            size *= 2
    _gn(out, f"{root}.{i}", sub["norm_out"])
    _conv(out, f"{root}.{i + 2}", sub["conv_out"])       # i + 1 is the Swish


def vqvae_state_from_jax(params: Dict[str, Any], cfg: Config) -> State:
    """The JAX VQVAE's params -> the port VQVAE's ``state_dict``."""
    vq = cfg.architecture.vqvae
    interm = list(vq.intermediate_channels)
    attn_res = list(vq.attention_resolution)
    out: State = {}
    _encoder(out, "encoder.model", params["encoder"], img_size=resolve_img_size(cfg),
             interm=interm, n_res=int(vq.num_residual_blocks_encoder), attn_res=attn_res)
    _decoder(out, "decoder.model", params["decoder"], latent_size=int(vq.latent_size),
             interm=interm, n_res=int(vq.num_residual_blocks_decoder), attn_res=attn_res)
    out["codebook.codebook.weight"] = _t(params["codebook"]["embedding"])
    _conv(out, "quant_conv", params["quant_conv"])
    _conv(out, "post_quant_conv", params["post_quant_conv"])
    return out


def gpt_state_from_jax(params: Dict[str, Any]) -> State:
    """The JAX GPT's params -> the port GPT's ``state_dict``."""
    out: State = {"tok_emb.weight": _t(params["tok_emb"]["embedding"]),
                  "pos_emb": _t(params["pos_emb"])}
    _ln(out, "ln_f", params["ln_f"])
    _dense(out, "head", params["head"])
    block_size = int(np.shape(params["pos_emb"])[1])
    mask = torch.tril(torch.ones(block_size, block_size)).reshape(1, 1, block_size, block_size)
    i = 0
    while f"block{i}" in params:
        sub, p = params[f"block{i}"], f"blocks.{i}"
        _ln(out, f"{p}.ln1", sub["ln1"])
        _ln(out, f"{p}.ln2", sub["ln2"])
        for name in ("query", "key", "value", "proj"):
            _dense(out, f"{p}.attn.{name}", sub["attn"][name])
        out[f"{p}.attn.mask"] = mask.clone()
        _dense(out, f"{p}.mlp.0", sub["fc1"])
        _dense(out, f"{p}.mlp.2", sub["fc2"])
        i += 1
    return out

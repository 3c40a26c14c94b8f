"""The JAX package's parameters -> the port's ``state_dict``s.

Takes the JAX package's parameter tree as a nested dict of numpy arrays and
returns ``{key: torch.Tensor}`` in the reference key layout that the port's
modules use, ready for ``load_state_dict(..., strict=True)``. The mapping
is this package's own copy:

- Dense kernels [in, out] -> Linear weights [out, in];
- Conv kernels HWIO -> OIHW (depthwise [3, 3, 1, C] -> [C, 1, 3, 3]);
  Conv1d kernels [K, I, O] -> [O, I, K];
- RMSNorm gains [C] -> [1, C, 1];
- BatchNorm scale / bias / mean / var -> weight / bias / running_mean /
  running_var, with ``num_batches_tracked`` 0;
- the port's GroupNorm keeps its affine under ``.group_norm``, the JAX
  package's under a nested ``GroupNorm_0``;
- minGPT's causal-mask buffer is regenerated from the positional-embedding
  length;
- flax attention kernels [C, H, Dh] (query, key, value) and [H, Dh, C]
  (out) become Linear weights [C, C], their biases [H, Dh] vectors [C].
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


def vae_state_from_jax(params: Dict[str, Any], cfg: Config) -> State:
    """The JAX VAE's params -> the port VAE's ``state_dict`` (the export
    tool's ``export_vae`` keys), its geometry from ``architecture.vae`` or
    else ``architecture.vqvae``."""
    vae = cfg.architecture.get("vae", cfg.architecture.get("vqvae"))
    interm = list(vae.intermediate_channels)
    attn_res = list(vae.attention_resolution)
    out: State = {}
    _encoder(out, "encoder.model", params["encoder"], img_size=resolve_img_size(cfg),
             interm=interm, n_res=int(vae.num_residual_blocks_encoder), attn_res=attn_res)
    _decoder(out, "decoder.model", params["decoder"], latent_size=int(vae.latent_size),
             interm=interm, n_res=int(vae.num_residual_blocks_decoder), attn_res=attn_res)
    _conv(out, "fc_mu", params["fc_mu"])
    _conv(out, "fc_logvar", params["fc_logvar"])
    return out


def _bn(out: State, p: str, sub_p, sub_s) -> None:
    out[f"{p}.weight"] = _t(sub_p["scale"])
    out[f"{p}.bias"] = _t(sub_p["bias"])
    out[f"{p}.running_mean"] = _t(sub_s["mean"])
    out[f"{p}.running_var"] = _t(sub_s["var"])
    out[f"{p}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)


def _conv_bn_silu(out: State, p: str, sub_p, sub_s) -> None:
    _conv(out, f"{p}.module.0", sub_p["conv"])
    _bn(out, f"{p}.module.1", sub_p["bn"], sub_s["bn"])


def _shuffle_unit(out: State, p: str, sub_p, sub_s) -> None:
    """A ResidualBottleneck or ResidualDownsample (the same names)."""
    _conv(out, f"{p}.branch1.0", sub_p["b1_dw"])
    _bn(out, f"{p}.branch1.1", sub_p["b1_bn"], sub_s["b1_bn"])
    _conv_bn_silu(out, f"{p}.branch1.2", sub_p["b1_pw"], sub_s["b1_pw"])
    _conv_bn_silu(out, f"{p}.branch2.0", sub_p["b2_pw1"], sub_s["b2_pw1"])
    _conv(out, f"{p}.branch2.1", sub_p["b2_dw"])
    _bn(out, f"{p}.branch2.2", sub_p["b2_bn"], sub_s["b2_bn"])
    _conv_bn_silu(out, f"{p}.branch2.3", sub_p["b2_pw2"], sub_s["b2_pw2"])


def shuffle_unet_state_from_jax(params: Dict[str, Any],
                                batch_stats: Dict[str, Any]) -> State:
    """The JAX ShuffleUNet's params and batch statistics -> the port
    ShuffleUNet's ``state_dict``. Depthwise kernels [3, 3, 1, C] become
    [C, 1, 3, 3] by the same HWIO -> OIHW transpose."""
    out: State = {}
    _conv_bn_silu(out, "init_conv", params["init_conv"], batch_stats["init_conv"])
    out["time_embedding.weight"] = _t(params["time_embedding"]["embedding"])

    def block(kind: str, blocks: str, last: str) -> None:
        i = 0
        while f"{kind}{i}" in params:
            p, sub_p, sub_s = f"{blocks}.{i}", params[f"{kind}{i}"], batch_stats[f"{kind}{i}"]
            for k in range(4):
                _shuffle_unit(out, f"{p}.conv0.{k}", sub_p[f"bn{k}"], sub_s[f"bn{k}"])
            _dense(out, f"{p}.time_mlp.mlp.0", sub_p["time_mlp"]["fc1"])
            _dense(out, f"{p}.time_mlp.mlp.2", sub_p["time_mlp"]["fc2"])
            _shuffle_unit(out, f"{p}.conv1", sub_p[last], sub_s[last])
            i += 1

    block("enc", "encoder_blocks", "down")
    i = 0
    while f"mid{i}" in params:
        _shuffle_unit(out, f"mid_block.{i}", params[f"mid{i}"], batch_stats[f"mid{i}"])
        i += 1
    block("dec", "decoder_blocks", "bn4")
    _conv(out, "final_conv", params["final_conv"])
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


def _mha(out: State, p: str, sub) -> None:
    """flax ``MultiHeadDotProductAttention``: query, key and value kernels
    [D_in, H, hd] (D_in the context's width for key and value), out [H, hd,
    D]."""
    for name in ("query", "key", "value", "out"):
        kernel = np.asarray(sub[name]["kernel"])
        c_out = kernel.shape[-1] if name == "out" else kernel.shape[1] * kernel.shape[2]
        out[f"{p}.{name}.weight"] = _t(kernel.reshape(-1, c_out).T)
        out[f"{p}.{name}.bias"] = _t(np.asarray(sub[name]["bias"]).reshape(-1))


def transformer_predictor_state_from_jax(params: Dict[str, Any]) -> State:
    """The JAX TransformerPredictor's params -> the port's ``state_dict``
    (its module names are the flax names)."""
    out: State = {"embedding.weight": _t(params["embedding"]["embedding"]),
                  "positional_encoding": _t(params["positional_encoding"]),
                  "time_embedding.weight": _t(params["time_embedding"]["embedding"])}
    i = 0
    while f"block{i}" in params:
        sub, p = params[f"block{i}"], f"block{i}"
        _ln(out, f"{p}.norm1", sub["norm1"])
        _dense(out, f"{p}.ada_ln_scale", sub["ada_ln_scale"])
        _dense(out, f"{p}.ada_ln_bias", sub["ada_ln_bias"])
        _mha(out, f"{p}.self_attention", sub["self_attention"])
        if "cross_attention" in sub:
            _ln(out, f"{p}.norm_cross", sub["norm_cross"])
            _mha(out, f"{p}.cross_attention", sub["cross_attention"])
        _ln(out, f"{p}.norm2", sub["norm2"])
        _dense(out, f"{p}.ffn1", sub["ffn1"])
        _dense(out, f"{p}.ffn2", sub["ffn2"])
        i += 1
    _dense(out, "fc", params["fc"])
    return out


def _conv1d(out: State, p: str, sub) -> None:
    out[f"{p}.weight"] = _t(np.transpose(np.asarray(sub["kernel"]), (2, 1, 0)))
    if "bias" in sub:
        out[f"{p}.bias"] = _t(sub["bias"])


def _rms(out: State, p: str, sub) -> None:
    out[f"{p}.g"] = _t(np.asarray(sub["g"]).reshape(1, -1, 1))


def _resnet1d(out: State, p: str, sub) -> None:
    _dense(out, f"{p}.mlp.1", sub["time_proj"])
    for block in ("block1", "block2"):
        _conv1d(out, f"{p}.{block}.proj", sub[block]["proj"])
        _rms(out, f"{p}.{block}.norm", sub[block]["RMSNorm_0"])
    if "res_conv" in sub:
        _conv1d(out, f"{p}.res_conv", sub["res_conv"])


def _attn1d(out: State, p: str, sub) -> None:
    _conv1d(out, f"{p}.to_qkv", sub["to_qkv"])
    if "out_norm" in sub:               # linear attention: to_out = (conv, RMSNorm)
        _conv1d(out, f"{p}.to_out.0", sub["to_out"])
        _rms(out, f"{p}.to_out.1", sub["out_norm"])
    else:
        _conv1d(out, f"{p}.to_out", sub["to_out"])


def unet1d_state_from_jax(params: Dict[str, Any]) -> State:
    """The JAX Unet1D's params -> the port Unet1D's ``state_dict``. flax
    adopts the attention modules that ``PreNormResidual`` wraps into the
    U-Net's own scope (``LinearAttention1D_{n}``, numbered over the downs
    and then the ups, and ``Attention1D_0``); the last up stage's bare conv
    sits at ``ups.{i}.3``, the others' behind the upsample at ``ups.{i}.3.1``.
    A learned or random sinusoid's weights go to ``time_mlp.0.weights``."""
    out: State = {}
    _conv1d(out, "init_conv", params["init_conv"])
    if "sinu" in params:
        out["time_mlp.0.weights"] = _t(params["sinu"]["weights"])
    _dense(out, "time_mlp.1", params["time_fc1"])
    _dense(out, "time_mlp.3", params["time_fc2"])
    n_lin = 0
    for kind, stages in (("down", "downs"), ("up", "ups")):
        n = sum(1 for k in params if k.startswith(kind) and k.endswith("_res1"))
        for i in range(n):
            p = f"{stages}.{i}"
            _resnet1d(out, f"{p}.0", params[f"{kind}{i}_res1"])
            _resnet1d(out, f"{p}.1", params[f"{kind}{i}_res2"])
            _rms(out, f"{p}.2.fn.norm", params[f"{kind}{i}_attn"]["RMSNorm_0"])
            _attn1d(out, f"{p}.2.fn.fn", params[f"LinearAttention1D_{n_lin}"])
            n_lin += 1
            last = kind == "up" and i == n - 1
            _conv1d(out, f"{p}.3" if kind == "down" or last else f"{p}.3.1",
                    params[f"{kind}{i}_{kind}"])
    _resnet1d(out, "mid_block1", params["mid_res1"])
    _rms(out, "mid_attn.fn.norm", params["mid_attn"]["RMSNorm_0"])
    _attn1d(out, "mid_attn.fn.fn", params["Attention1D_0"])
    _resnet1d(out, "mid_block2", params["mid_res2"])
    _resnet1d(out, "final_res_block", params["final_res"])
    _conv1d(out, "final_conv", params["final_conv"])
    return out


def _rms2d(out: State, p: str, sub) -> None:
    out[f"{p}.g"] = _t(np.asarray(sub["g"]).reshape(1, -1, 1, 1))


def _resnet2d(out: State, p: str, sub) -> None:
    _dense(out, f"{p}.mlp.1", sub["time_proj"])
    for block in ("block1", "block2"):
        _conv(out, f"{p}.{block}.proj", sub[block]["proj"])
        _rms2d(out, f"{p}.{block}.norm", sub[block]["RMSNorm2D_0"])
    if "res_conv" in sub:
        _conv(out, f"{p}.res_conv", sub["res_conv"])


def _attn2d(out: State, p: str, sub) -> None:
    _rms2d(out, f"{p}.norm", sub["norm"])
    out[f"{p}.mem_kv"] = _t(sub["mem_kv"])
    _conv(out, f"{p}.to_qkv", sub["to_qkv"])
    if "out_norm" in sub:               # linear attention: to_out = (conv, RMSNorm)
        _conv(out, f"{p}.to_out.0", sub["to_out"])
        _rms2d(out, f"{p}.to_out.1", sub["out_norm"])
    else:
        _conv(out, f"{p}.to_out", sub["to_out"])


def unet2d_state_from_jax(params: Dict[str, Any]) -> State:
    """The JAX Unet2DPixel's params -> the port Unet2DPixel's ``state_dict``.
    The JAX export tool has no family for this net, so the keys are the
    port's own (the reference's module layout): a down stage's
    space-to-depth conv sits at ``downs.{i}.3.conv``, the innermost's 3x3
    conv at ``downs.{i}.3``; an up stage's conv behind the upsample at
    ``ups.{i}.3.1``, the outermost's at ``ups.{i}.3``. A learned or random
    sinusoid's weights go to ``time_mlp.0.weights``."""
    out: State = {}
    _conv(out, "init_conv", params["init_conv"])
    if "sinu" in params:
        out["time_mlp.0.weights"] = _t(params["sinu"]["weights"])
    _dense(out, "time_mlp.1", params["time_fc1"])
    _dense(out, "time_mlp.3", params["time_fc2"])
    for kind, stages in (("down", "downs"), ("up", "ups")):
        n = sum(1 for k in params if k.startswith(kind) and k.endswith("_res1"))
        for i in range(n):
            p = f"{stages}.{i}"
            _resnet2d(out, f"{p}.0", params[f"{kind}{i}_res1"])
            _resnet2d(out, f"{p}.1", params[f"{kind}{i}_res2"])
            _attn2d(out, f"{p}.2", params[f"{kind}{i}_attn"])
            last = i == n - 1
            _conv(out, {("down", False): f"{p}.3.conv", ("down", True): f"{p}.3",
                        ("up", False): f"{p}.3.1", ("up", True): f"{p}.3"}[kind, last],
                  params[f"{kind}{i}_{kind}"])
    _resnet2d(out, "mid_block1", params["mid_res1"])
    _attn2d(out, "mid_attn", params["mid_attn"])
    _resnet2d(out, "mid_block2", params["mid_res2"])
    _resnet2d(out, "final_res_block", params["final_res"])
    _conv(out, "final_conv", params["final_conv"])
    return out


def _conv_transpose(out: State, p: str, sub) -> None:
    """flax ConvTranspose (no kernel transpose) [kh, kw, in, out] -> torch
    ConvTranspose2d [in, out, kh, kw], the kernel flipped in space: flax
    convolves the dilated input with the kernel as given, torch's transposed
    convolution with it mirrored."""
    kernel = np.asarray(sub["kernel"])[::-1, ::-1]
    out[f"{p}.weight"] = _t(np.transpose(kernel, (2, 3, 0, 1)))
    out[f"{p}.bias"] = _t(sub["bias"])


def simple_unet_state_from_jax(params: Dict[str, Any]) -> State:
    """The JAX SimpleUNet's params -> the port SimpleUNet's ``state_dict``
    (the port's own keys, as for :func:`unet2d_state_from_jax`)."""
    out: State = {}
    _dense(out, "time_fc", params["time_fc"])
    n = sum(1 for k in params if k.startswith("time_to_"))
    for i in range(n):
        _conv(out, f"downs.{i}.0", params[f"down{i}_c1"])
        _conv(out, f"downs.{i}.2", params[f"down{i}_c2"])
        _dense(out, f"time_to.{i}", params[f"time_to_{i}"])
        _conv_transpose(out, f"ups_t.{i}", params[f"up{i}_t"])
        _conv(out, f"ups.{i}.0", params[f"up{i}_c1"])
        _conv(out, f"ups.{i}.2", params[f"up{i}_c2"])
    _conv(out, "bottleneck.0", params["bottleneck_c1"])
    _conv(out, "bottleneck.2", params["bottleneck_c2"])
    _conv(out, "out", params["out"])
    return out


def discriminator_state_from_jax(params: Dict[str, Any], batch_stats: Dict[str, Any]) -> State:
    """The JAX Discriminator's params and batch statistics -> the port
    Discriminator's ``state_dict`` (``model.0``, ``model.2/3``, ``model.5/6``,
    ``model.8/9``, ``model.11``)."""
    out: State = {}
    _conv(out, "model.0", params["conv0"])
    for i, base in enumerate((2, 5, 8), start=1):
        _conv(out, f"model.{base}", params[f"conv{i}"])
        _bn(out, f"model.{base + 1}", params[f"bn{i}"], batch_stats[f"bn{i}"])
    _conv(out, "model.11", params["conv_out"])
    return out


def lpips_state_from_jax(params: Dict[str, Any]) -> State:
    """The JAX LPIPS params (``vgg/conv{s}_{i}/kernel|bias`` HWIO, ``lin{i}``)
    -> the port LPIPS's ``state_dict``."""
    out: State = {}
    for name, sub in params["vgg"].items():
        _conv(out, f"vgg.{name}", sub)
    for key, value in params.items():
        if key != "vgg":
            out[key] = _t(np.asarray(value).reshape(-1))
    return out

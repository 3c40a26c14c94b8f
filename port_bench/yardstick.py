"""The yardstick: the H100's published rates and the operations and bytes
of the port's kernels and models, all from shapes.

The peaks are NVIDIA's data sheet (H100 SXM, dense, 700 W). Operation
counts follow ``torch.utils.flop_counter.FlopCounterMode``'s convention: two
operations a multiply-add of every convolution and matrix product, nothing
for normalisations, activations and element-wise work. A training step
counts its prior's backward as twice its forward.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

F32_PEAK_FLOPS = 67e12      # f32 outside the tensor cores
BF16_PEAK_FLOPS = 989e12    # dense bf16 tensor cores
_BYTES = {"float32": 4, "bfloat16": 2}


def hbm_bytes_per_s(name: str) -> float:
    """Published device-memory rate of the H100 variant ``name`` names."""
    if "PCIe" in name:
        return 2.0e12
    if "NVL" in name:
        return 3.9e12
    return 3.35e12


def peak_flops(dtype: str) -> float:
    return F32_PEAK_FLOPS if dtype == "float32" else BF16_PEAK_FLOPS


# -- kernel B1: the GPT decode stack, one position through all layers -----

def decode_stack_bound_ms(dtype: str, name: str, n_layer: int, batch: int, width: int,
                          positions: int) -> Tuple[float, str]:
    """Least time of one decode-stack call with weights and cache in
    ``dtype``, averaged over the positions t = 0..positions-1: bytes
    (weights, the f32 LayerNorm and bias vectors, x in and out, cache rows
    < t read, new rows written) over the memory rate, or operations over
    the peak rate of ``dtype``, whichever is larger. Returns (ms, "bytes"
    or "operations")."""
    L, B, C, N = n_layer, batch, width, positions
    es = _BYTES[dtype]
    weights = L * 12 * C * C * es + L * 13 * C * 4
    mean_t = (N - 1) / 2
    rows = L * B * (mean_t + 1)
    bytes_ = weights + 2 * B * C * 4 + rows * 2 * C * es
    ops = 2 * B * L * 12 * C * C + 4 * B * L * mean_t * C
    by_bytes, by_ops = bytes_ / hbm_bytes_per_s(name), ops / peak_flops(dtype)
    return 1e3 * max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops else "operations")


# -- kernels K1 and K2: the ShuffleNet units of the gaussian3d U-Net -------

def shuffle_unit_bound(kind: str, h: int, w: int, c_in: int, c_out: int, batch: int,
                       dtype: str, name: str) -> Tuple[float, float]:
    """(ms by bytes, ms by operations) of one ShuffleNet unit ("K1" a
    bottleneck, "K2" a downsample) on [batch, h, w, c_in]: its input read
    once, its parameters read once and its output written once, over the
    memory rate of the card ``name``; both depthwise convolutions and the
    three pointwise products over the peak rate of ``dtype``."""
    es = _BYTES[dtype]
    co2, p_in = c_out // 2, batch * h * w
    if kind == "K1":
        ch, p_out = c_in // 2, p_in
        ops = 2 * p_in * (18 * ch + 2 * ch * co2 + ch * ch)
        params = 20 * ch + ch * ch + 2 * ch * co2 + 2 * co2
    else:
        p_out = p_in // 4
        ops = 2 * (p_out * (9 * c_in + 9 * co2 + co2 * co2) + (p_in + p_out) * c_in * co2)
        params = 10 * c_in + 10 * co2 + 2 * c_in * co2 + co2 * co2 + 3 * co2
    bytes_ = (p_in * c_in + p_out * c_out + params) * es
    return 1e3 * bytes_ / hbm_bytes_per_s(name), 1e3 * ops / peak_flops(dtype)


def unet_sizes(cfg: dict) -> dict:
    """The ShuffleNet U-Net's widths as the configuration states them."""
    return dict(cfg["unet"])


def unet_unit_shapes(h: int, w: int, base: int, mults: Sequence[int]
                     ) -> List[Tuple[str, int, int, int, int]]:
    """(kernel, H, W, C_in, C_out) of every ShuffleNet unit of one U-Net
    forward on an [B, h, w, C] input, in order: each encoder block 4
    bottlenecks ("K1") and a downsample ("K2", H and W halved, rounded up),
    3 mid bottlenecks, each decoder block 5 bottlenecks on the upsampled
    input joined with its skip."""
    dims = [base] + [base * m for m in mults]
    pairs = list(zip(dims[:-1], dims[1:]))
    units, skips, c = [], [], base
    for _, c_out in pairs:
        units += [("K1", h, w, c, c)] * 3 + [("K1", h, w, c, c_out // 2),
                                             ("K2", h, w, c_out // 2, c_out)]
        skips.append((h, w, c_out // 2))
        h, w, c = (h + 1) // 2, (w + 1) // 2, c_out
    units += [("K1", h, w, c, c)] * 2 + [("K1", h, w, c, c // 2)]
    c //= 2
    for c_in, _ in reversed(pairs):
        h, w, skip = skips.pop()
        c += skip
        units += [("K1", h, w, c, c)] * 3 + [("K1", h, w, c, c // 2),
                                             ("K1", h, w, c // 2, c_in // 2)]
        c = c_in // 2
    return units


# -- model operations ------------------------------------------------------

def _conv(b: int, h: int, w: int, cin: int, cout: int, k: int, groups: int = 1) -> int:
    return 2 * b * h * w * cout * (cin // groups) * k * k


def _res(b, s, cin, cout):
    return _conv(b, s, s, cin, cout, 3) + _conv(b, s, s, cout, cout, 3) + \
        (_conv(b, s, s, cin, cout, 1) if cin != cout else 0)


def _nonlocal(b, s, c):
    return 4 * _conv(b, s, s, c, c, 1) + 2 * 2 * b * (s * s) ** 2 * c


def encoder_flops(vq: dict, img: int, img_ch: int, b: int) -> int:
    """The stage-1 encoder, quant conv and the quantizer's distance product
    on b images."""
    ch = [vq["intermediate_channels"][0], *vq["intermediate_channels"]]
    attn, n_res, lat = set(vq["attention_resolution"]), vq["num_residual_blocks_encoder"], \
        vq["latent_channels"]
    s, total = img, _conv(b, img, img, img_ch, ch[0], 3)
    for n in range(len(ch) - 1):
        cin = ch[n]
        for _ in range(n_res):
            total += _res(b, s, cin, ch[n + 1])
            cin = ch[n + 1]
            total += _nonlocal(b, s, cin) if s in attn else 0
        if n != len(ch) - 2:
            total += _conv(b, s // 2, s // 2, cin, cin, 3)
            s //= 2
    c = ch[-1]
    total += 2 * _res(b, s, c, c) + _nonlocal(b, s, c) + _conv(b, s, s, c, lat, 3)
    total += _conv(b, s, s, lat, lat, 1)
    return total + 2 * b * s * s * lat * vq["num_codebook_vectors"]


def decoder_flops(vq: dict, img_ch: int, b: int) -> int:
    """Post-quant conv and the stage-1 decoder on b code grids."""
    ch = list(vq["intermediate_channels"])[::-1]
    attn, n_res, lat = set(vq["attention_resolution"]), vq["num_residual_blocks_decoder"], \
        vq["latent_channels"]
    s, c0 = vq["latent_size"], ch[0]
    total = _conv(b, s, s, lat, lat, 1) + _conv(b, s, s, lat, c0, 3)
    total += 2 * _res(b, s, c0, c0) + _nonlocal(b, s, c0)
    cin = c0
    for n, c in enumerate(ch):
        for _ in range(n_res):
            total += _res(b, s, cin, c)
            cin = c
            total += _nonlocal(b, s, c) if s in attn else 0
        if n:
            s *= 2
            total += _conv(b, s, s, c, c, 3)
    return total + _conv(b, s, s, cin, img_ch, 3)


def gpt_layer_flops(b: int, t: int, c: int) -> int:
    """The products of one block's projections and MLP on b x t tokens."""
    return 24 * b * t * c * c


def gpt_forward_flops(g: dict, b: int, t: int) -> int:
    """The GPT's full causal forward on [b, t] tokens, the attention's
    products over all t x t scores as a plain forward computes them."""
    c, L = g["n_embd"], g["n_layer"]
    return L * (gpt_layer_flops(b, t, c) + 4 * b * t * t * c) + 2 * b * t * c * g["vocab_size"]


def gpt_decode_flops(g: dict, b: int, positions: int) -> int:
    """``positions`` decode steps of b rows, position t attending over t + 1
    cache rows (the causal work alone)."""
    c, L = g["n_embd"], g["n_layer"]
    attn = 4 * b * c * positions * (positions + 1) // 2
    return L * (gpt_layer_flops(b, positions, c) + attn) + \
        2 * b * positions * c * g["vocab_size"]


def unet_flops(u: dict, b: int, h: int, w: int) -> int:
    """One ShuffleNet U-Net forward on [b, h, w, in] with its time MLPs."""
    base, mults, emb = u["base_dim"], u["dim_mults"], u["time_embedding_dim"]
    total = _conv(b, h, w, u["in_channels"], base, 3)
    for kind, hh, ww, cin, cout in unet_unit_shapes(h, w, base, mults):
        if kind == "K1":
            ch, co2 = cin // 2, cout // 2
            total += 2 * b * hh * ww * (18 * ch + 2 * ch * co2 + ch * ch)
        else:
            co2, ho, wo = cout // 2, (hh + 1) // 2, (ww + 1) // 2
            total += 2 * b * (ho * wo * (9 * cin + 9 * co2 + co2 * co2) +
                              (hh * ww + ho * wo) * cin * co2)
    dims = [base] + [base * m for m in mults]
    for cout in dims[1:]:                 # encoder and decoder time MLPs
        total += 2 * 2 * b * (emb * cout + cout * cout // 2)
    return total + _conv(b, h, w, base // 2, u["out_channels"], 1)

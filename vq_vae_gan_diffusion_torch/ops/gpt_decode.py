"""GPT decode stack: one decode position through all L transformer blocks.

The PyTorch counterpart of the JAX ``ops/gpt_decode_pallas.py``:

- :func:`pack_decode_params` stacks the blocks' weights into [L, ...] tensors,
  as float or as quantized levels with their scales;
- :func:`reference_decode_stack` is the plain PyTorch version of the function;
- :func:`fused_decode_stack` (float weights), :func:`fused_decode_stack_q`
  (int8 or int4 weights, float cache) and :func:`fused_decode_stack_qkv`
  (int8 or int4 weights, int8 cache) launch the hand-written CUDA kernel
  (``csrc/gpt_decode.cu``: one persistent cooperative launch a call) for
  CUDA tensors and run the plain version for CPU tensors;
- :func:`record_phase_stamps` is the kernel's profiling switch
  (``profile_decode.py``).

Per layer: LN1 -> joint QKV -> attention over the cache rows < t, with the
current token's k/v folded into the softmax analytically -> proj + residual
-> LN2 -> fc1 -> exact-erf GELU -> fc2 + residual. The residual stream, LN and
softmax statistics are f32; weights and the cache are f32 or bf16 with f32
accumulation, and operands are rounded to that type where the JAX reference
rounds them. Weights keep ``nn.Linear``'s [out, in] layout.

Quantized weights (the JAX package's ``decode_quant``) are symmetric integer
levels with f32 scales, one scale per output row and group of the
contraction axis: a product is the sum over groups of (the activation,
rounded to the compute type, times the levels) times the group's scale.
int8 has one group, but fc2 two (the JAX package quantizes fc2's two
2C-wide input halves apart); int4 has 8 groups of C/8 and fc2 16 of C/4.
int4 levels are nibble-packed in a uint8 tensor of half the width: byte k of
a row holds element 2k in its low nibble and 2k + 1 in its high one.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from ._build import library

_MAX_CACHE_ROWS = 8192   # the kernel keeps t scores in shared memory
_MAX_WIDTH = 4096        # a LayerNorm thread holds at most 16 of a row's C values


QUANT_MODES = (None, "int8", "int8kv", "int4", "int4kv")   # decode_quant
_NG = 8                  # int4 groups along the contraction axis (fc2: 2 x 8)
_EPS = 1e-8              # the least max |w| a scale is taken from


def _scale(amax: torch.Tensor, levels: int) -> torch.Tensor:
    """max(amax, 1e-8) / levels, correctly rounded on every device: PyTorch's
    CUDA division by a Python number multiplies by its reciprocal, which
    would give the card other scales (and levels) than the CPU and the JAX
    package, so the divisor is a tensor."""
    amax = amax.clamp_min(_EPS)
    return amax / torch.full_like(amax, levels)


def _quantize(w: torch.Tensor, groups: int, levels: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric quantization of ``w`` [L, N, K] in ``groups`` equal groups
    along K: scale = max(max |w|, 1e-8) / levels per (row, group), levels
    round(w / scale) (half to even) clipped to [-levels, levels]. Returns
    (int8 levels [L, N, K], f32 scales [L, N, groups])."""
    l_, n, k = w.shape
    wg = w.float().reshape(l_, n, groups, k // groups)
    s = _scale(wg.abs().amax(-1), levels)
    q = torch.clamp(torch.round(wg / s[..., None]), -levels, levels)
    return q.reshape(l_, n, k).to(torch.int8), s


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """int4 levels [..., K] (int8 in [-7, 7]) -> uint8 [..., K/2]: byte k holds
    element 2k in its low nibble and element 2k + 1 in its high one."""
    q = q.to(torch.int16)
    return ((q[..., 0::2] & 15) | ((q[..., 1::2] & 15) << 4)).to(torch.uint8)


def unpack_int4(w: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_int4`: uint8 [..., K/2] -> int8 levels [..., K]."""
    v = w.to(torch.int16)
    lo, hi = ((v & 15) ^ 8) - 8, ((v >> 4) ^ 8) - 8
    return torch.stack([lo, hi], -1).reshape(*w.shape[:-1], 2 * w.shape[-1]).to(torch.int8)


def _levels(w: torch.Tensor) -> torch.Tensor:
    """A packed weight's values as f32: float weights as they are, int8 and
    nibble-packed int4 levels unscaled."""
    return unpack_int4(w).float() if w.dtype == torch.uint8 else w.float()


@torch.no_grad()
def pack_decode_params(gpt, dtype: torch.dtype = torch.float32,
                       quant: Optional[str] = None) -> Dict[str, torch.Tensor]:
    """Stack ``gpt``'s block weights into [L, ...] tensors on its device.

    Query/key/value weights join into one [3C, C] product. With ``quant``
    None, GEMM weights are cast to ``dtype``. With ``int8``/``int8kv`` they
    become int8 levels, with ``int4``/``int4kv`` nibble-packed uint8 [L, N,
    K/2], each quantized from the f32 weights (``dtype`` is then the compute
    type, which the caller passes to the kernel); the scales are ``sqkv`` [L,
    3C, G], ``sproj`` [L, C, G], ``sfc1`` [L, 4C, G] and ``sfc2`` [L, C, 2G]
    with G = 1 (int8) or 8 (int4). The *kv modes pack the same weights: their
    cache is the caller's. LayerNorm affines and biases stay f32.
    """
    if quant not in QUANT_MODES:
        raise ValueError(f"unsupported quant mode {quant!r}")
    blocks = gpt.blocks

    def stack(get, cast):
        return torch.stack([get(blk) for blk in blocks]).to(cast).contiguous()

    def qkv(blk, part):
        a = blk.attn
        return torch.cat([getattr(a.query, part), getattr(a.key, part),
                          getattr(a.value, part)], 0)

    f32 = torch.float32
    weights = {
        "wqkv": lambda b: qkv(b, "weight"),          # [L, 3C, C]
        "wproj": lambda b: b.attn.proj.weight,       # [L, C, C]
        "wfc1": lambda b: b.mlp[0].weight,           # [L, 4C, C]
        "wfc2": lambda b: b.mlp[2].weight,           # [L, C, 4C]
    }
    packed = {
        "ln1_s": stack(lambda b: b.ln1.weight, f32),
        "ln1_b": stack(lambda b: b.ln1.bias, f32),
        "bqkv": stack(lambda b: qkv(b, "bias"), f32),              # [L, 3C]
        "bproj": stack(lambda b: b.attn.proj.bias, f32),
        "ln2_s": stack(lambda b: b.ln2.weight, f32),
        "ln2_b": stack(lambda b: b.ln2.bias, f32),
        "bfc1": stack(lambda b: b.mlp[0].bias, f32),
        "bfc2": stack(lambda b: b.mlp[2].bias, f32),
    }
    if quant is None:
        packed.update({key: stack(get, dtype) for key, get in weights.items()})
        return packed
    int4 = quant.startswith("int4")
    c = gpt.n_embd
    if int4 and c % (2 * _NG):
        raise ValueError(f"int4 needs n_embd % {2 * _NG} == 0, got {c}")
    groups = _NG if int4 else 1
    for key, get in weights.items():
        q, s = _quantize(stack(get, f32), 2 * groups if key == "wfc2" else groups,
                         7 if int4 else 127)
        packed[key] = (pack_int4(q) if int4 else q).contiguous()
        packed["s" + key[1:]] = s.contiguous()
    return packed


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    return xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps) * scale + bias


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in f32: an operand of an f32-
    accumulated product in ``dtype``."""
    return x.to(dtype).float()


def _compute_dtype(kv: torch.Tensor, compute_dtype: Optional[torch.dtype]) -> torch.dtype:
    """The type operands are rounded to: a float cache's own, else
    ``compute_dtype`` (default float32) for an int8 cache."""
    if kv.dtype == torch.int8:
        return compute_dtype or torch.float32
    if compute_dtype not in (None, kv.dtype):
        raise ValueError(f"a {kv.dtype} cache computes in {kv.dtype}, not {compute_dtype}")
    return kv.dtype


def _quantize_rows(v: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row symmetric int8 of v [B, C]: (levels [B, C] f32, scales [B, 1])."""
    s = _scale(v.abs().amax(-1, keepdim=True), 127)
    return torch.clamp(torch.round(v / s), -127, 127), s


@torch.no_grad()
def reference_decode_stack(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                           kv: torch.Tensor, t: int, *, n_head: int,
                           kv_scales: Optional[torch.Tensor] = None,
                           compute_dtype: Optional[torch.dtype] = None) -> Tuple[torch.Tensor, ...]:
    """The plain PyTorch decode stack, for float or quantized ``packed``;
    the contract of :func:`fused_decode_stack` or, given ``kv_scales``, of
    :func:`fused_decode_stack_qkv`.

    Quantized products scale each group's f32 partial before adding it. With
    an int8 cache, history scores are multiplied by their row's k-scale and
    the softmax weights by its v-scale before the V sum; the current token's
    own term uses its f32 k and v; its new rows are quantized per (layer,
    batch row) over all C lanes of k and of v.
    """
    l_, b, n, c2 = kv.shape
    c = c2 // 2
    d = c // n_head
    dtype = _compute_dtype(kv, compute_dtype)
    x = x.float()

    def mm(key: str, i: int, xin: torch.Tensor) -> torch.Tensor:
        xin = _round(xin, dtype)
        scales = packed.get("s" + key[1:])
        if scales is None:
            return xin @ packed[key][i].float().T
        s = scales[i]                                   # [N, G]
        g = s.shape[-1]
        w = _levels(packed[key][i])                     # [N, K]
        part = torch.einsum("bgk,ngk->bng", xin.reshape(b, g, -1),
                            w.reshape(w.shape[0], g, -1))
        return (part * s).sum(-1)

    news, scs = [], []
    for i in range(l_):
        qkv = mm("wqkv", i, _ln(x, packed["ln1_s"][i], packed["ln1_b"][i])) + packed["bqkv"][i]
        q = (qkv[:, :c] * d ** -0.5).reshape(b, n_head, d)
        k_new, v_new = qkv[:, c:2 * c], qkv[:, 2 * c:]
        att_self = (q * k_new.reshape(b, n_head, d)).sum(-1)          # [B, H]
        m = att_self
        if t > 0:
            kc = kv[i, :, :t, :c].float().reshape(b, t, n_head, d)
            att = torch.einsum("bhd,bnhd->bnh", _round(q, dtype), kc)
            if kv_scales is not None:
                att = att * kv_scales[i, :, :t, 0, None]
            m = torch.maximum(m, att.amax(1))
        es = torch.exp(att_self - m)
        num = es[..., None] * v_new.reshape(b, n_head, d)
        denom = es
        if t > 0:
            e = torch.exp(att - m[:, None, :])
            ev = e if kv_scales is None else e * kv_scales[i, :, :t, 1, None]
            vc = kv[i, :, :t, c:].float().reshape(b, t, n_head, d)
            num = torch.einsum("bnh,bnhd->bhd", _round(ev, dtype), vc) + num
            denom = e.sum(1) + denom
        y = (num / denom[..., None]).reshape(b, c)
        x = x + mm("wproj", i, y) + packed["bproj"][i]
        h = mm("wfc1", i, _ln(x, packed["ln2_s"][i], packed["ln2_b"][i])) + packed["bfc1"][i]
        x = x + mm("wfc2", i, torch.nn.functional.gelu(h)) + packed["bfc2"][i]
        if kv_scales is None:
            news.append(torch.cat([k_new, v_new], -1).to(kv.dtype))
        else:
            (kq, sk), (vq, sv) = _quantize_rows(k_new), _quantize_rows(v_new)
            news.append(torch.cat([kq, vq], -1).to(torch.int8))
            scs.append(torch.cat([sk, sv], -1))
    if kv_scales is None:
        return x, torch.stack(news)
    return x, torch.stack(news), torch.stack(scs)


def _weight_bits(packed: Dict[str, torch.Tensor]) -> int:
    """0 for float weights, 8 for int8 levels, 4 for nibble-packed int4."""
    if "sqkv" not in packed:
        return 0
    return 4 if packed["wqkv"].dtype == torch.uint8 else 8


def _check_cuda_args(x, packed, kv, t, n_head, kv_scales=None, compute_dtype=None) -> None:
    if kv.dim() != 4 or kv.shape[-1] % 2:
        raise ValueError(f"kv must be [L, B, N, 2C], got {tuple(kv.shape)}")
    l_, b, n, c2 = kv.shape
    c = c2 // 2
    bits = _weight_bits(packed)
    if kv.dtype == torch.int8:
        if kv_scales is None:
            raise ValueError("an int8 cache needs its kv_scales")
        if not bits:
            raise ValueError("an int8 KV cache requires quantized weights (int8kv, int4kv)")
    elif kv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kv must be float32, bfloat16 or int8, got {kv.dtype}")
    elif kv_scales is not None:
        raise ValueError("kv_scales given but kv is not int8")
    dtype = _compute_dtype(kv, compute_dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"compute type must be float32 or bfloat16, got {dtype}")
    if x.dtype != torch.float32 or tuple(x.shape) != (b, c):
        raise ValueError(f"x must be float32 [{b}, {c}], got {x.dtype} {tuple(x.shape)}")
    d = c // n_head
    if c % 8 or c > _MAX_WIDTH or c % n_head or d not in (8, 16, 32, 64, 128):
        raise ValueError(f"C={c} must be a multiple of 8 up to {_MAX_WIDTH} and of "
                         f"n_head={n_head}, with a head width of 8, 16, 32, 64 or 128")
    if kv.dtype == torch.int8 and d < 16:
        raise ValueError(f"an int8 cache needs a head width of at least 16, got {d}")
    if bits == 4 and c % (2 * _NG):
        raise ValueError(f"int4 needs n_embd % {2 * _NG} == 0, got {c}")
    if bits == 4 and c % 64:
        raise ValueError(f"the int4 kernel needs C % 64 == 0 (groups of C/8 in slices "
                         f"of 8 columns), got {c}")
    if not 0 <= t < n or n > _MAX_CACHE_ROWS:
        raise ValueError(f"need 0 <= t < N <= {_MAX_CACHE_ROWS}, got t={t}, N={n}")
    wtype = {0: dtype, 8: torch.int8, 4: torch.uint8}[bits]
    kdiv = 2 if bits == 4 else 1
    g = _NG if bits == 4 else 1
    shapes = {"wqkv": (wtype, (l_, 3 * c, c // kdiv)), "wproj": (wtype, (l_, c, c // kdiv)),
              "wfc1": (wtype, (l_, 4 * c, c // kdiv)), "wfc2": (wtype, (l_, c, 4 * c // kdiv))}
    if bits:
        shapes.update({"sqkv": (torch.float32, (l_, 3 * c, g)),
                       "sproj": (torch.float32, (l_, c, g)),
                       "sfc1": (torch.float32, (l_, 4 * c, g)),
                       "sfc2": (torch.float32, (l_, c, 2 * g))})
    for key, shape in {"ln1_s": (l_, c), "ln1_b": (l_, c), "bqkv": (l_, 3 * c),
                       "bproj": (l_, c), "ln2_s": (l_, c), "ln2_b": (l_, c),
                       "bfc1": (l_, 4 * c), "bfc2": (l_, c)}.items():
        shapes[key] = (torch.float32, shape)
    for key, (want, shape) in shapes.items():
        p = packed[key]
        if tuple(p.shape) != shape or p.dtype != want:
            raise ValueError(f"packed[{key!r}] must be {want} {shape}, got "
                             f"{p.dtype} {tuple(p.shape)}")
    tensors = [("x", x), ("kv", kv)] + list(packed.items())
    if kv_scales is not None:
        if tuple(kv_scales.shape) != (l_, b, n, 2) or kv_scales.dtype != torch.float32:
            raise ValueError(f"kv_scales must be float32 {(l_, b, n, 2)}, got "
                             f"{kv_scales.dtype} {tuple(kv_scales.shape)}")
        tensors.append(("kv_scales", kv_scales))
    for name, tensor in tensors:
        if tensor.device != kv.device:
            raise ValueError(f"{name} is on {tensor.device}, kv on {kv.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _route(name: str, kv: torch.Tensor) -> bool:
    """True for the kernel (a CUDA cache), False for the plain version (a CPU
    cache); any other device raises."""
    if kv.device.type not in ("cuda", "cpu"):
        raise ValueError(f"{name} runs on cuda or cpu, not {kv.device}")
    return kv.device.type == "cuda"


def fused_decode_stack(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                       kv: torch.Tensor, t: int, *, n_head: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all transformer blocks for one decode position (float weights).

    Args:
      x: [B, C] f32, the token embedding plus the positional embedding.
      packed: stacked weights from :func:`pack_decode_params`, in kv's dtype.
      kv: [L, B, N, 2C] cache, K in ``[..., :C]`` and V in ``[..., C:]``. Only
        rows < t are read. It is not updated here: the caller writes the
        returned rows at position t (``kv[:, :, t] = kv_new``).
      t: the current position, a Python int.

    Returns (x_out [B, C] f32 before ``ln_f``, kv_new [L, B, 2C] in kv's dtype).

    CUDA tensors go through the CUDA kernel, one cooperative launch that
    adds one to ``fused_decode_stack.launches`` (and, in bf16, to
    ``.bf16_launches``); a failed launch (a grid
    that cannot be co-resident among them) raises. CPU tensors go through
    :func:`reference_decode_stack`. Any other device raises.
    """
    if _weight_bits(packed):
        raise ValueError("quantized weights go through fused_decode_stack_q or _qkv")
    if not _route("fused_decode_stack", kv):
        return reference_decode_stack(x, packed, kv, t, n_head=n_head)
    _check_cuda_args(x, packed, kv, t, n_head)
    l_, b, n, c2 = kv.shape
    c = c2 // 2
    lib = _bind()
    x_out = torch.empty_like(x)
    kv_new = torch.empty((l_, b, c2), dtype=kv.dtype, device=kv.device)
    work = torch.empty(int(lib.gpt_decode_workspace_floats(b, c, 0)),
                       dtype=torch.float32, device=kv.device)
    fn = lib.gpt_decode_stack_f32 if kv.dtype == torch.float32 else lib.gpt_decode_stack_bf16
    p = packed
    err = fn(x.data_ptr(), x_out.data_ptr(), p["ln1_s"].data_ptr(),
             p["ln1_b"].data_ptr(), p["wqkv"].data_ptr(), p["bqkv"].data_ptr(),
             p["wproj"].data_ptr(), p["bproj"].data_ptr(), p["ln2_s"].data_ptr(),
             p["ln2_b"].data_ptr(), p["wfc1"].data_ptr(), p["bfc1"].data_ptr(),
             p["wfc2"].data_ptr(), p["bfc2"].data_ptr(), kv.data_ptr(),
             kv_new.data_ptr(), work.data_ptr(), l_, b, n, c, n_head, t,
             torch.cuda.current_stream(kv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gpt_decode_stack launch failed: cudaError {err}")
    fused_decode_stack.launches += 1
    fused_decode_stack.bf16_launches += kv.dtype == torch.bfloat16
    return x_out, kv_new


fused_decode_stack.launches = 0
fused_decode_stack.bf16_launches = 0      # the launches of the bf16 instantiation


def _launch_quant(x, packed, kv, kv_scales, t, n_head, dtype):
    """One launch of the quantized decode stack (B2b with a float cache, B2c
    with an int8 cache); returns (x_out, kv_new[, sc_new])."""
    l_, b, n, c2 = kv.shape
    c = c2 // 2
    bits = _weight_bits(packed)
    lib = _bind()
    x_out = torch.empty_like(x)
    kv_new = torch.empty((l_, b, c2), dtype=kv.dtype, device=kv.device)
    sc_new = torch.empty((l_, b, 2), dtype=torch.float32, device=kv.device)
    work = torch.empty(int(lib.gpt_decode_workspace_floats(b, c, bits)),
                       dtype=torch.float32, device=kv.device)
    p = packed
    err = lib.gpt_decode_stack_quant(
        x.data_ptr(), x_out.data_ptr(), p["ln1_s"].data_ptr(), p["ln1_b"].data_ptr(),
        p["wqkv"].data_ptr(), p["sqkv"].data_ptr(), p["bqkv"].data_ptr(),
        p["wproj"].data_ptr(), p["sproj"].data_ptr(), p["bproj"].data_ptr(),
        p["ln2_s"].data_ptr(), p["ln2_b"].data_ptr(),
        p["wfc1"].data_ptr(), p["sfc1"].data_ptr(), p["bfc1"].data_ptr(),
        p["wfc2"].data_ptr(), p["sfc2"].data_ptr(), p["bfc2"].data_ptr(),
        kv.data_ptr(), None if kv_scales is None else kv_scales.data_ptr(),
        kv_new.data_ptr(), sc_new.data_ptr(), work.data_ptr(),
        l_, b, n, c, n_head, t, int(dtype == torch.bfloat16), bits,
        torch.cuda.current_stream(kv.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gpt_decode_stack_quant launch failed: cudaError {err}")
    return (x_out, kv_new) if kv_scales is None else (x_out, kv_new, sc_new)


def fused_decode_stack_q(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                         kv: torch.Tensor, t: int, *, n_head: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`fused_decode_stack` on int8 or int4 weights (``packed`` from
    :func:`pack_decode_params` with ``quant`` int8 or int4) and a float cache,
    which sets the compute type. CUDA tensors go through the CUDA kernel,
    which adds one to ``fused_decode_stack_q.launches`` per call; CPU tensors
    go through :func:`reference_decode_stack`. Any other device raises."""
    if not _weight_bits(packed):
        raise ValueError("fused_decode_stack_q takes quantized weights")
    if not _route("fused_decode_stack_q", kv):
        return reference_decode_stack(x, packed, kv, t, n_head=n_head)
    _check_cuda_args(x, packed, kv, t, n_head)
    out = _launch_quant(x, packed, kv, None, t, n_head, kv.dtype)
    fused_decode_stack_q.launches += 1
    return out


fused_decode_stack_q.launches = 0


def fused_decode_stack_qkv(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                           kv: torch.Tensor, kv_scales: torch.Tensor, t: int, *,
                           n_head: int, compute_dtype: torch.dtype = torch.float32
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """:func:`fused_decode_stack_q` with an int8 cache.

    Args:
      kv: [L, B, N, 2C] int8 levels; row n of layer l dequantizes as
        k = kv[l, :, n, :C] * kv_scales[l, :, n, 0, None] and
        v = kv[l, :, n, C:] * kv_scales[l, :, n, 1, None].
      kv_scales: [L, B, N, 2] f32, the (k, v) scale of every cache row (the
        JAX package keeps them as [L, N, 2B]).
      compute_dtype: float32 or bfloat16, the type operands are rounded to.

    Returns (x_out [B, C] f32, kv_new [L, B, 2C] int8, sc_new [L, B, 2] f32):
    the caller commits both at row t. CUDA tensors go through the CUDA
    kernel, which adds one to ``fused_decode_stack_qkv.launches`` per call;
    CPU tensors go through :func:`reference_decode_stack`.
    """
    if not _weight_bits(packed):
        raise ValueError("an int8 KV cache requires quantized weights (int8kv, int4kv)")
    if not _route("fused_decode_stack_qkv", kv):
        return reference_decode_stack(x, packed, kv, t, n_head=n_head, kv_scales=kv_scales,
                                      compute_dtype=compute_dtype)
    _check_cuda_args(x, packed, kv, t, n_head, kv_scales, compute_dtype)
    out = _launch_quant(x, packed, kv, kv_scales, t, n_head, compute_dtype)
    fused_decode_stack_qkv.launches += 1
    return out


fused_decode_stack_qkv.launches = 0


def stamp_rows(n_layer: int) -> int:
    """Rows of phase stamps a launch writes: its start, the 8 barriers of
    each layer, its end."""
    return 8 * n_layer + 2


def record_phase_stamps(stamps: Optional[torch.Tensor]) -> None:
    """Profiling: every later decode-stack launch writes %globaltimer stamps
    (nanoseconds) to ``stamps``, a contiguous int64 CUDA tensor, or refuses
    to launch when they do not fit; None turns them off (the default, which
    costs the serving path nothing). Layout: ``stamps[0]`` the grid size G,
    ``stamps[1]`` the rows R (:func:`stamp_rows`), then [R, G + 1]: row 0
    each block's start; row i = 1 .. 8L barrier i of the phases (LN1, QKV,
    attention, proj, LN2, fc1, GELU, fc2 a layer), column b the arrival of
    block b, column G the moment block 0 leaves it; row R - 1 each block's
    end. The library holds a reference to the tensor while it is set."""
    if stamps is not None and (stamps.dtype != torch.int64 or stamps.device.type != "cuda"
                               or not stamps.is_contiguous()):
        raise ValueError("stamps must be a contiguous int64 CUDA tensor")
    lib = _bind()
    lib.gpt_decode_set_stamps(None if stamps is None else stamps.data_ptr(),
                              0 if stamps is None else stamps.numel())
    lib.stamps = stamps   # the kernel writes there until the next call


def _bind() -> ctypes.CDLL:
    """The kernel library with its C signatures declared."""
    lib = library("gpt_decode")
    if not getattr(lib, "_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gpt_decode_workspace_floats.argtypes = [i32, i32, i32]
        lib.gpt_decode_workspace_floats.restype = ctypes.c_longlong
        lib.gpt_decode_set_stamps.argtypes = [ptr, ctypes.c_longlong]
        lib.gpt_decode_set_stamps.restype = None
        for fn in (lib.gpt_decode_stack_f32, lib.gpt_decode_stack_bf16):
            fn.argtypes = [ptr] * 17 + [i32] * 6 + [ptr]
            fn.restype = i32
        lib.gpt_decode_stack_quant.argtypes = [ptr] * 23 + [i32] * 8 + [ptr]
        lib.gpt_decode_stack_quant.restype = i32
        lib._bound = True
    return lib

"""GPT decode stack: one decode position through all L transformer blocks.

The PyTorch counterpart of the JAX ``ops/gpt_decode_pallas.py``:

- :func:`pack_decode_params` stacks the blocks' weights into [L, ...] tensors;
- :func:`reference_decode_stack` is the plain PyTorch version of the function;
- :func:`fused_decode_stack` launches the hand-written CUDA kernel
  (``csrc/gpt_decode.cu``) for CUDA tensors and runs the plain version for
  CPU tensors.

Per layer: LN1 -> joint QKV -> attention over the cache rows < t, with the
current token's k/v folded into the softmax analytically -> proj + residual
-> LN2 -> fc1 -> exact-erf GELU -> fc2 + residual. The residual stream, LN and
softmax statistics are f32; weights and the cache are f32 or bf16 with f32
accumulation, and operands are rounded to that type where the JAX reference
rounds them. Weights keep ``nn.Linear``'s [out, in] layout.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from ._build import library

_WEIGHTS = ("wqkv", "wproj", "wfc1", "wfc2")
_MAX_CACHE_ROWS = 8192   # the kernel keeps t scores in shared memory
_MAX_WIDTH = 4096        # a LayerNorm thread holds at most 4 of a row's C values


@torch.no_grad()
def pack_decode_params(gpt, dtype: torch.dtype = torch.float32
                       ) -> Dict[str, torch.Tensor]:
    """Stack ``gpt``'s block weights into [L, ...] tensors on its device.

    Query/key/value weights join into one [3C, C] product. GEMM weights are
    cast to ``dtype``; LayerNorm affines and biases stay f32.
    """
    blocks = gpt.blocks

    def stack(get, cast):
        return torch.stack([get(blk) for blk in blocks]).to(cast).contiguous()

    def qkv(blk, part):
        a = blk.attn
        return torch.cat([getattr(a.query, part), getattr(a.key, part),
                          getattr(a.value, part)], 0)

    f32 = torch.float32
    return {
        "ln1_s": stack(lambda b: b.ln1.weight, f32),
        "ln1_b": stack(lambda b: b.ln1.bias, f32),
        "wqkv": stack(lambda b: qkv(b, "weight"), dtype),          # [L, 3C, C]
        "bqkv": stack(lambda b: qkv(b, "bias"), f32),              # [L, 3C]
        "wproj": stack(lambda b: b.attn.proj.weight, dtype),       # [L, C, C]
        "bproj": stack(lambda b: b.attn.proj.bias, f32),
        "ln2_s": stack(lambda b: b.ln2.weight, f32),
        "ln2_b": stack(lambda b: b.ln2.bias, f32),
        "wfc1": stack(lambda b: b.mlp[0].weight, dtype),           # [L, 4C, C]
        "bfc1": stack(lambda b: b.mlp[0].bias, f32),
        "wfc2": stack(lambda b: b.mlp[2].weight, dtype),           # [L, C, 4C]
        "bfc2": stack(lambda b: b.mlp[2].bias, f32),
    }


def _ln(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
        eps: float = 1e-5) -> torch.Tensor:
    mu = x.mean(-1, keepdim=True)
    xc = x - mu
    return xc * torch.rsqrt((xc * xc).mean(-1, keepdim=True) + eps) * scale + bias


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` rounded to ``dtype`` and held in f32: an operand of an f32-
    accumulated product in ``dtype``."""
    return x.to(dtype).float()


@torch.no_grad()
def reference_decode_stack(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                           kv: torch.Tensor, t: int, *, n_head: int
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch decode stack; same contract as :func:`fused_decode_stack`."""
    l_, b, n, c2 = kv.shape
    c = c2 // 2
    d = c // n_head
    dtype = kv.dtype
    x = x.float()
    news = []
    for i in range(l_):
        xn = _round(_ln(x, packed["ln1_s"][i], packed["ln1_b"][i]), dtype)
        qkv = xn @ packed["wqkv"][i].float().T + packed["bqkv"][i]
        q = (qkv[:, :c] * d ** -0.5).reshape(b, n_head, d)
        k_new, v_new = qkv[:, c:2 * c], qkv[:, 2 * c:]
        att_self = (q * k_new.reshape(b, n_head, d)).sum(-1)          # [B, H]
        m = att_self
        if t > 0:
            kc = kv[i, :, :t, :c].float().reshape(b, t, n_head, d)
            att = torch.einsum("bhd,bnhd->bnh", _round(q, dtype), kc)
            m = torch.maximum(m, att.amax(1))
        es = torch.exp(att_self - m)
        num = es[..., None] * v_new.reshape(b, n_head, d)
        denom = es
        if t > 0:
            e = torch.exp(att - m[:, None, :])
            vc = kv[i, :, :t, c:].float().reshape(b, t, n_head, d)
            num = torch.einsum("bnh,bnhd->bhd", _round(e, dtype), vc) + num
            denom = e.sum(1) + denom
        y = _round((num / denom[..., None]).reshape(b, c), dtype)
        x = x + y @ packed["wproj"][i].float().T + packed["bproj"][i]
        hn = _round(_ln(x, packed["ln2_s"][i], packed["ln2_b"][i]), dtype)
        h = hn @ packed["wfc1"][i].float().T + packed["bfc1"][i]
        h = _round(torch.nn.functional.gelu(h), dtype)
        x = x + h @ packed["wfc2"][i].float().T + packed["bfc2"][i]
        news.append(torch.cat([k_new, v_new], -1).to(dtype))
    return x, torch.stack(news)


def _check_cuda_args(x, packed, kv, t, n_head) -> None:
    if kv.dim() != 4 or kv.shape[-1] % 2:
        raise ValueError(f"kv must be [L, B, N, 2C], got {tuple(kv.shape)}")
    l_, b, n, c2 = kv.shape
    c = c2 // 2
    if kv.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"kv must be float32 or bfloat16, got {kv.dtype}")
    if x.dtype != torch.float32 or tuple(x.shape) != (b, c):
        raise ValueError(f"x must be float32 [{b}, {c}], got {x.dtype} {tuple(x.shape)}")
    d = c // n_head
    if c % 8 or c > _MAX_WIDTH or c % n_head or d not in (8, 16, 32, 64, 128):
        raise ValueError(f"C={c} must be a multiple of 8 up to {_MAX_WIDTH} and of "
                         f"n_head={n_head}, with a head width of 8, 16, 32, 64 or 128")
    if not 0 <= t < n or n > _MAX_CACHE_ROWS:
        raise ValueError(f"need 0 <= t < N <= {_MAX_CACHE_ROWS}, got t={t}, N={n}")
    shapes = {"wqkv": (l_, 3 * c, c), "wproj": (l_, c, c), "wfc1": (l_, 4 * c, c),
              "wfc2": (l_, c, 4 * c), "ln1_s": (l_, c), "ln1_b": (l_, c),
              "bqkv": (l_, 3 * c), "bproj": (l_, c), "ln2_s": (l_, c),
              "ln2_b": (l_, c), "bfc1": (l_, 4 * c), "bfc2": (l_, c)}
    for key, shape in shapes.items():
        p = packed[key]
        want = kv.dtype if key in _WEIGHTS else torch.float32
        if tuple(p.shape) != shape or p.dtype != want:
            raise ValueError(f"packed[{key!r}] must be {want} {shape}, got "
                             f"{p.dtype} {tuple(p.shape)}")
    for name, tensor in [("x", x), ("kv", kv)] + list(packed.items()):
        if tensor.device != kv.device:
            raise ValueError(f"{name} is on {tensor.device}, kv on {kv.device}")
        if not tensor.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def fused_decode_stack(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                       kv: torch.Tensor, t: int, *, n_head: int
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run all transformer blocks for one decode position.

    Args:
      x: [B, C] f32, the token embedding plus the positional embedding.
      packed: stacked weights from :func:`pack_decode_params`, in kv's dtype.
      kv: [L, B, N, 2C] cache, K in ``[..., :C]`` and V in ``[..., C:]``. Only
        rows < t are read. It is not updated here: the caller writes the
        returned rows at position t (``kv[:, :, t] = kv_new``).
      t: the current position, a Python int.

    Returns (x_out [B, C] f32 before ``ln_f``, kv_new [L, B, 2C] in kv's dtype).

    CUDA tensors go through the CUDA kernel, which adds one to
    ``fused_decode_stack.launches`` per call; CPU tensors go through
    :func:`reference_decode_stack`. Any other device raises.
    """
    if kv.device.type == "cpu":
        return reference_decode_stack(x, packed, kv, t, n_head=n_head)
    if kv.device.type != "cuda":
        raise ValueError(f"fused_decode_stack runs on cuda or cpu, not {kv.device}")
    _check_cuda_args(x, packed, kv, t, n_head)
    l_, b, n, c2 = kv.shape
    c = c2 // 2
    lib = _bind()
    x_out = torch.empty_like(x)
    kv_new = torch.empty((l_, b, c2), dtype=kv.dtype, device=kv.device)
    work = torch.empty(int(lib.gpt_decode_workspace_floats(b, c)),
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
    return x_out, kv_new


fused_decode_stack.launches = 0


def _bind() -> ctypes.CDLL:
    """The kernel library with its C signatures declared."""
    lib = library("gpt_decode")
    if not getattr(lib, "_bound", False):
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gpt_decode_workspace_floats.argtypes = [i32, i32]
        lib.gpt_decode_workspace_floats.restype = ctypes.c_longlong
        for fn in (lib.gpt_decode_stack_f32, lib.gpt_decode_stack_bf16):
            fn.argtypes = [ptr] * 17 + [i32] * 6 + [ptr]
            fn.restype = i32
        lib._bound = True
    return lib

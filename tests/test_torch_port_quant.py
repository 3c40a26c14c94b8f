"""The port's quantized GPT decode path (int8/int4 weights, int8 KV cache)
against the JAX package's ``decode_quant`` modes.

Weights are transplanted from JAX (vq_vae_gan_diffusion_torch.weights) at a
tiny size (B=2, L=2, H=4, C=64, N=128: N a multiple of the JAX chunked
kernel's 64-row chunks, C a multiple of 16 for int4). The port's integer
levels and scales equal the JAX package's element for element; its plain
quantized stack is held to the Pallas chunked kernel in interpret mode, and
its sampler to the JAX fused sampler, in every mode. The CUDA kernels run
only on the card (chip_smoke.py (l)-(n)).

Tolerances: x_out within 1e-4 (the same f32 products summed in other orders
through two layers); the new int8 cache rows at most one level apart (a k
or v that lies on a rounding boundary may round either way after another
sum order) and their scales within 1e-5 relative.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch.models.mingpt import GPT as TorchGPT
from vq_vae_gan_diffusion_torch.models.mingpt import categorical, fused_step
from vq_vae_gan_diffusion_torch.models.mingpt import sample_tokens as t_sample_tokens
from vq_vae_gan_diffusion_torch.ops import gpt_decode as tgd
from vq_vae_gan_diffusion_torch.weights import gpt_state_from_jax
from vq_vae_gan_diffusion_tpu.models.mingpt import GPT as JaxGPT
from vq_vae_gan_diffusion_tpu.models.mingpt import sample_tokens as j_sample_tokens
from vq_vae_gan_diffusion_tpu.ops import gpt_decode_pallas as jgd

B, N, L, H, C, V = 2, 128, 2, 4, 64, 64
MODES = ("int8", "int8kv", "int4", "int4kv")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more,
    and with every core busy a full thread pool makes each small op slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    jgpt = JaxGPT(vocab_size=V, block_size=N, n_layer=L, n_head=H, n_embd=C)
    params = jgpt.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * jnp.sin(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape),
        params)
    # a wide logit spread, so near-ties cannot decide quasi-greedy sampling
    params["head"]["kernel"] = params["head"]["kernel"] * 50.0
    params = jax.device_get(params)
    tgpt = TorchGPT(vocab_size=V, block_size=N, n_layer=L, n_head=H, n_embd=C)
    tgpt.load_state_dict(gpt_state_from_jax(params), strict=True)
    return jgpt, params, tgpt.eval()


def _jax_levels_as_port(jp: dict, int4: bool) -> dict:
    """The JAX chunk streams' levels and scales in the port's [out, in]
    layout: wattn [L, 4, C, C] (q, k, v, proj; [in, out]) and wmlp [L, 4, C,
    2C] (fc1 column half 0, fc2 row half 0 transposed, fc1 half 1, fc2 half
    1), unpacked from their nibble pairs (rows r, r + R/2) first for int4."""
    def full(w):
        if not int4:
            return np.asarray(w, np.int32)
        lo, hi = jgd._unpack_nibbles(jnp.asarray(w), jnp.int32)
        return np.concatenate([np.asarray(lo), np.asarray(hi)], axis=-2)

    def sw(a):
        return np.swapaxes(a, -1, -2)

    wa, wm = full(jp["wattn"]), full(jp["wmlp"])
    sa, sm = np.asarray(jp["sattn"]), np.asarray(jp["smlp"])
    return {
        "wqkv": np.concatenate([sw(wa[:, i]) for i in range(3)], 1),
        "wproj": sw(wa[:, 3]),
        "wfc1": np.concatenate([sw(wm[:, 0]), sw(wm[:, 2])], 1),
        "wfc2": np.concatenate([wm[:, 1], wm[:, 3]], 2),
        "sqkv": np.concatenate([sw(sa[:, i]) for i in range(3)], 1),
        "sproj": sw(sa[:, 3]),
        "sfc1": np.concatenate([sw(sm[:, 0]), sw(sm[:, 2])], 1),
        "sfc2": np.concatenate([sw(sm[:, 1, :, :C]), sw(sm[:, 3, :, :C])], 2),
    }


@pytest.mark.parametrize("fmt", ["int8", "int4"])
def test_levels_and_scales_equal_jax(setup, fmt):
    """(a) The port's levels and scales are the JAX package's, bit for bit."""
    _, params, tgpt = setup
    int4 = fmt == "int4"
    want = _jax_levels_as_port(jgd.pack_decode_params_chunked(params, L, jnp.float32, fmt),
                               int4)
    got = tgd.pack_decode_params(tgpt, quant=fmt)
    for key in ("wqkv", "wproj", "wfc1", "wfc2"):
        w = got[key]
        assert w.dtype == (torch.uint8 if int4 else torch.int8)
        levels = tgd.unpack_int4(w) if int4 else w
        np.testing.assert_array_equal(levels.numpy().astype(np.int32), want[key], err_msg=key)
        s = got["s" + key[1:]]
        assert s.shape[-1] == (8 if int4 else 1) * (2 if key == "wfc2" else 1)
        np.testing.assert_array_equal(s.numpy(), want["s" + key[1:]], err_msg=key)
    if int4:
        q = torch.from_numpy(np.random.RandomState(0).randint(-7, 8, (3, 32))).to(torch.int8)
        assert torch.equal(tgd.unpack_int4(tgd.pack_int4(q)), q)


def _caches(quant_kv: bool, seed: int = 1):
    """A pre-filled cache (garbage past t): f32 normal, or int8 levels with
    per-row scales in the port's [L, B, N, 2] and the JAX [L, N, 2B] layout."""
    rs = np.random.RandomState(seed)
    x = rs.standard_normal((B, C)).astype(np.float32)
    if not quant_kv:
        return x, rs.standard_normal((L, B, N, 2 * C)).astype(np.float32), None, None
    kv = rs.randint(-127, 128, (L, B, N, 2 * C)).astype(np.int8)
    sc = rs.uniform(0.005, 0.02, (L, B, N, 2)).astype(np.float32)
    jsc = np.concatenate([np.transpose(sc[..., 0], (0, 2, 1)),
                          np.transpose(sc[..., 1], (0, 2, 1))], -1)
    return x, kv, sc, jsc


@pytest.mark.parametrize("mode", MODES)
def test_plain_quant_stack_matches_pallas_chunked(setup, mode):
    """(b) The port's plain quantized stack against the JAX chunked kernel
    in interpret mode, at t in {0, 1, 63, 64, 127}."""
    _, params, tgpt = setup
    quant_kv = mode.endswith("kv")
    jp = jgd.pack_decode_params_chunked(params, L, jnp.float32, mode)
    tp = tgd.pack_decode_params(tgpt, quant=mode)
    x, kv, sc, jsc = _caches(quant_kv)
    jfn = jax.jit(lambda t: jgd.fused_decode_stack_chunked(
        jnp.asarray(x), jp, jnp.asarray(kv), t, n_head=H,
        kv_scales=None if jsc is None else jnp.asarray(jsc),
        compute_dtype=jnp.float32, interpret=True))
    for t in (0, 1, 63, 64, 127):
        want = jfn(jnp.int32(t))
        got = tgd.reference_decode_stack(
            torch.from_numpy(x), tp, torch.from_numpy(kv), t, n_head=H,
            kv_scales=None if sc is None else torch.from_numpy(sc))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-4, atol=1e-4,
                                   err_msg=f"x_out t={t}")
        if not quant_kv:
            np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-4,
                                       atol=1e-4, err_msg=f"kv_new t={t}")
            continue
        rows = got[1].numpy().astype(np.int32) - np.asarray(want[1], np.int32)
        assert np.abs(rows).max() <= 1 and (rows == 0).mean() >= 0.99, f"kv_new t={t}"
        jnew = np.asarray(want[2])[:, 0]                                 # [L, 2B]
        np.testing.assert_allclose(got[2].numpy(), np.stack([jnew[:, :B], jnew[:, B:]], -1),
                                   rtol=1e-5, err_msg=f"scales t={t}")


@pytest.mark.parametrize("mode", MODES)
def test_sampler_matches_jax_fused_sampler(setup, mode):
    """(c) Quasi-greedy sampling through a 4-token teacher-forced prefix
    picks the JAX fused sampler's tokens in every quant mode."""
    jgpt, params, tgpt = setup
    rs = np.random.RandomState(3)
    prefix = np.concatenate([np.zeros((B, 1), np.int32),
                             rs.randint(0, V, (B, 3)).astype(np.int32)], 1)
    kw = dict(prefix_len=4, steps=8, temperature=1e-4, top_k=10)
    want = j_sample_tokens(jgpt, jax.tree_util.tree_map(jnp.asarray, params),
                           jax.random.PRNGKey(7), jnp.asarray(prefix),
                           fused=True, quant=mode, interpret=True, **kw)
    got = t_sample_tokens(tgpt, torch.from_numpy(prefix).long(), quant=mode,
                          generator=torch.Generator().manual_seed(7), **kw)
    assert got.shape == (B, 8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quant_wrappers_take_plain_version_on_cpu(setup):
    """(d) CPU tensors go through the plain version; no launch is counted."""
    _, _, tgpt = setup
    before = (tgd.fused_decode_stack_q.launches, tgd.fused_decode_stack_qkv.launches)
    x, kv, _, _ = _caches(False)
    packed = tgd.pack_decode_params(tgpt, quant="int4")
    got = tgd.fused_decode_stack_q(torch.from_numpy(x), packed, torch.from_numpy(kv), 5,
                                   n_head=H)
    want = tgd.reference_decode_stack(torch.from_numpy(x), packed, torch.from_numpy(kv), 5,
                                      n_head=H)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    x, kv, sc, _ = _caches(True)
    packed = tgd.pack_decode_params(tgpt, quant="int8kv")
    got = tgd.fused_decode_stack_qkv(torch.from_numpy(x), packed, torch.from_numpy(kv),
                                     torch.from_numpy(sc), 5, n_head=H)
    want = tgd.reference_decode_stack(torch.from_numpy(x), packed, torch.from_numpy(kv), 5,
                                      n_head=H, kv_scales=torch.from_numpy(sc))
    assert len(got) == 3 and got[1].dtype == torch.int8 and tuple(got[2].shape) == (L, B, 2)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert (tgd.fused_decode_stack_q.launches, tgd.fused_decode_stack_qkv.launches) == before


def test_quant_bad_arguments_raise(setup):
    """(e) An int8 cache with float weights, int4 at C % 16 != 0, an unknown
    mode, and what the kernel does not take."""
    _, _, tgpt = setup
    x, kv, sc, _ = _caches(True)
    x_t, kv_t, sc_t = torch.from_numpy(x), torch.from_numpy(kv), torch.from_numpy(sc)
    with pytest.raises(ValueError, match="requires quantized weights"):
        tgd.fused_decode_stack_qkv(x_t, tgd.pack_decode_params(tgpt), kv_t, sc_t, 0, n_head=H)
    with pytest.raises(ValueError, match="requires quantized weights"):
        tgd._check_cuda_args(x_t, tgd.pack_decode_params(tgpt), kv_t, 0, H, sc_t)
    narrow = TorchGPT(vocab_size=V, block_size=16, n_layer=1, n_head=2, n_embd=40)
    with pytest.raises(ValueError, match="n_embd % 16"):
        tgd.pack_decode_params(narrow, quant="int4")
    with pytest.raises(ValueError, match="unsupported quant mode"):
        tgd.pack_decode_params(tgpt, quant="int2")
    with pytest.raises(ValueError, match="unsupported quant mode"):
        t_sample_tokens(tgpt, torch.zeros(B, 1, dtype=torch.long), 1, 4, quant="fp8")
    with pytest.raises(ValueError, match="quantized weights"):
        tgd.fused_decode_stack_q(x_t, tgd.pack_decode_params(tgpt), kv_t.float(), 0, n_head=H)
    with pytest.raises(ValueError, match="fused_decode_stack_q"):
        tgd.fused_decode_stack(x_t, tgd.pack_decode_params(tgpt, quant="int8"), kv_t.float(), 0,
                               n_head=H)
    packed = tgd.pack_decode_params(tgpt, quant="int8kv")
    tgd._check_cuda_args(x_t, packed, kv_t, 3, H, sc_t)
    with pytest.raises(ValueError, match="needs its kv_scales"):
        tgd._check_cuda_args(x_t, packed, kv_t, 3, H)
    with pytest.raises(ValueError, match="kv_scales must be"):
        tgd._check_cuda_args(x_t, packed, kv_t, 3, H, sc_t[:, :, :, :1].contiguous())
    with pytest.raises(ValueError, match="head width of at least 16"):
        tgd._check_cuda_args(x_t, packed, kv_t, 3, 8, sc_t)
    with pytest.raises(ValueError, match="C % 256"):
        wide = TorchGPT(vocab_size=V, block_size=16, n_layer=1, n_head=2, n_embd=32)
        tgd._check_cuda_args(torch.zeros(1, 32), tgd.pack_decode_params(wide, quant="int4"),
                             torch.zeros(1, 1, 4, 64), 0, 2)
    with pytest.raises(ValueError, match="packed\\['sfc2'\\]"):
        bad = dict(packed, sfc2=packed["sfc2"][..., :1].contiguous())
        tgd._check_cuda_args(x_t, bad, kv_t, 3, H, sc_t)


def test_generate_cli_int8kv_on_cpu(tmp_path, tiny_config):
    """(f) The CLI on a tiny config with ``decode_quant: int8kv``."""
    data = tiny_config.to_dict()
    data["architecture"]["model_name"] = "vqvae_transformer"
    data["architecture"]["vqvae_transformer"]["decode_quant"] = "int8kv"
    data["trainer"]["log_dir"] = str(tmp_path / "logs")
    path = tmp_path / "tiny_int8kv.yml"
    path.write_text(yaml.safe_dump(data))
    out = generate.run(["--config", str(path), "--n-samples", "2", "--device", "cpu"])
    tokens, images = out["tokens"], out["images"]
    assert tuple(tokens.shape) == (2, 64) and int(tokens.min()) >= 0 and int(tokens.max()) < 64
    assert tuple(images.shape) == (2, 32, 32, 3) and torch.isfinite(images).all()
    assert len(glob.glob(str(tmp_path / "logs" / "*" / "*_generate" / "run_*" /
                             "samples_epoch0.jpg"))) == 1


def test_fused_step_teacher_forced_repeats_the_sampler(setup):
    """``fused_step`` is the sampler's per-position function: fed the
    sampler's own tokens, with the sampler's uniforms handed to
    ``categorical``, it draws those tokens again (temperature 1, int8kv)."""
    _, _, tgpt = setup
    prefix = torch.zeros(B, 1, dtype=torch.long)
    tokens = t_sample_tokens(tgpt, prefix, 1, 6, top_k=None, quant="int8kv",
                             generator=torch.Generator().manual_seed(4))
    uniform = torch.rand(6, B, V, generator=torch.Generator().manual_seed(4))
    step = fused_step(tgpt, B, 6, quant="int8kv")
    seq = torch.cat([prefix, tokens[:, :-1]], 1)
    got = torch.stack([categorical(step(seq[:, t], t), None, uniform[t]) for t in range(6)], 1)
    assert torch.equal(got, tokens)

"""The port's decode stack (vq_vae_gan_diffusion_torch/ops/gpt_decode.py)
against the JAX package's (ops/gpt_decode_pallas.py).

The same numpy inputs, from a seed, go through the JAX Pallas kernel in
interpret mode, the JAX plain reference and the port's plain reference, on
weights transplanted with vq_vae_gan_diffusion_torch.weights. The CUDA kernel
itself runs only on the card (chip_smoke.py); here the wrapper's CPU route
and its loud failures are checked.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.models.mingpt import GPT as TorchGPT
from vq_vae_gan_diffusion_torch.ops import _build
from vq_vae_gan_diffusion_torch.ops import gpt_decode as tgd
from vq_vae_gan_diffusion_torch.weights import gpt_state_from_jax
from vq_vae_gan_diffusion_tpu.models.mingpt import GPT as JaxGPT
from vq_vae_gan_diffusion_tpu.ops import gpt_decode_pallas as jgd

B, N, L, H, C, V = 2, 16, 2, 4, 64, 64


@pytest.fixture(scope="module")
def setup():
    jgpt = JaxGPT(vocab_size=V, block_size=N, n_layer=L, n_head=H, n_embd=C)
    params = jgpt.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    # non-trivial weights so the LN, attention and GELU paths all matter
    params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * jnp.sin(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape),
        params)
    params = jax.device_get(params)
    tgpt = TorchGPT(vocab_size=V, block_size=N, n_layer=L, n_head=H, n_embd=C)
    tgpt.load_state_dict(gpt_state_from_jax(params), strict=True)
    rs = np.random.RandomState(0)
    kv = rs.standard_normal((L, B, N, 2 * C)).astype(np.float32)  # garbage past t
    x = rs.standard_normal((B, C)).astype(np.float32)
    return params, tgpt, kv, x


def test_pack_matches_jax(setup):
    params, tgpt, _, _ = setup
    jp = jgd.pack_decode_params(params, L, dtype=jnp.float32)
    tp = tgd.pack_decode_params(tgpt)
    for key in ("wqkv", "wproj", "wfc1", "wfc2"):       # [L, in, out] vs [L, out, in]
        np.testing.assert_array_equal(tp[key].numpy(), np.swapaxes(np.asarray(jp[key]), 1, 2))
    for key in ("ln1_s", "ln1_b", "bqkv", "bproj", "ln2_s", "ln2_b", "bfc1", "bfc2"):
        np.testing.assert_array_equal(tp[key].numpy(), np.asarray(jp[key])[:, 0])
    assert tgd.pack_decode_params(tgpt, torch.bfloat16)["wfc1"].dtype == torch.bfloat16


@pytest.mark.parametrize("t", [0, 1, 7, 15])
def test_reference_matches_jax_kernel_and_reference(setup, t):
    """Port plain version == JAX Pallas kernel (interpret) == JAX plain
    version, within 2e-5, with a randomly pre-filled cache."""
    params, tgpt, kv, x = setup
    jp = jgd.pack_decode_params(params, L, dtype=jnp.float32)
    h_t, kv_t = tgd.reference_decode_stack(torch.from_numpy(x), tgd.pack_decode_params(tgpt),
                                           torch.from_numpy(kv), t, n_head=H)
    h_k, kv_k = jgd.fused_decode_stack(jnp.asarray(x), jp, jnp.asarray(kv), jnp.int32(t),
                                       n_head=H, interpret=True)
    h_r, kv_r = jgd.reference_decode_stack(jnp.asarray(x), jp, jnp.asarray(kv), jnp.int32(t),
                                           n_head=H)
    for want_h, want_kv in ((h_k, kv_k), (h_r, kv_r)):
        np.testing.assert_allclose(h_t.numpy(), np.asarray(want_h), rtol=2e-5, atol=2e-5)
        np.testing.assert_allclose(kv_t.numpy(), np.asarray(want_kv), rtol=2e-5, atol=2e-5)


def test_reference_bf16_matches_jax_reference(setup):
    """bf16 weights and cache: the port rounds where the JAX reference rounds.
    Tolerance 2e-2: one bf16 step is 2^-8 of a value, and the two frameworks
    may round a sum that lies on a boundary differently."""
    params, tgpt, kv, x = setup
    jp = jgd.pack_decode_params(params, L, dtype=jnp.bfloat16)
    kv_b = torch.from_numpy(kv).bfloat16()
    h_t, kv_t = tgd.reference_decode_stack(
        torch.from_numpy(x), tgd.pack_decode_params(tgpt, torch.bfloat16), kv_b, 9, n_head=H)
    h_r, kv_r = jgd.reference_decode_stack(
        jnp.asarray(x), jp, jnp.asarray(kv_b.float().numpy()).astype(jnp.bfloat16),
        jnp.int32(9), n_head=H)
    assert kv_t.dtype == torch.bfloat16
    np.testing.assert_allclose(h_t.numpy(), np.asarray(h_r), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(kv_t.float().numpy(), np.asarray(kv_r, np.float32),
                               rtol=2e-2, atol=2e-2)


def test_wrapper_takes_plain_version_on_cpu(setup):
    """CPU tensors go through the plain version, and no kernel launch is counted."""
    _, tgpt, kv, x = setup
    packed = tgd.pack_decode_params(tgpt)
    before = tgd.fused_decode_stack.launches
    got = tgd.fused_decode_stack(torch.from_numpy(x), packed, torch.from_numpy(kv), 5, n_head=H)
    want = tgd.reference_decode_stack(torch.from_numpy(x), packed, torch.from_numpy(kv), 5,
                                      n_head=H)
    assert tgd.fused_decode_stack.launches == before
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_wrapper_raises_off_cpu_and_cuda(setup):
    _, tgpt, _, _ = setup
    packed = {k: v.to("meta") for k, v in tgd.pack_decode_params(tgpt).items()}
    with pytest.raises(ValueError, match="cuda or cpu"):
        tgd.fused_decode_stack(torch.empty(B, C, device="meta"), packed,
                               torch.empty(L, B, N, 2 * C, device="meta"), 0, n_head=H)


def test_cuda_tensors_on_a_cuda_less_machine_raise(setup, monkeypatch):
    """Asking for the kernel where there is no CUDA fails loudly: no CUDA
    tensor can be made, and the kernel cannot be built without nvcc."""
    from vq_vae_gan_diffusion_torch.utils import resolve_device
    if not torch.cuda.is_available():
        _, tgpt, kv, x = setup
        with pytest.raises((RuntimeError, AssertionError)):
            tgd.fused_decode_stack(torch.from_numpy(x).to("cuda"), tgd.pack_decode_params(tgpt),
                                   torch.from_numpy(kv).to("cuda"), 0, n_head=H)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.library.__wrapped__("gpt_decode")
    assert _build.sources() == ["discrete_posterior", "gpt_decode", "shuffle_units"]


def test_wrapper_rejects_bad_cuda_arguments(setup):
    """The argument checks that guard the kernel raise on what it does not take."""
    _, tgpt, kv, x = setup
    packed = tgd.pack_decode_params(tgpt)
    kv_t, x_t = torch.from_numpy(kv), torch.from_numpy(x)
    with pytest.raises(ValueError, match="0 <= t < N"):
        tgd._check_cuda_args(x_t, packed, kv_t, N, H)
    with pytest.raises(ValueError, match="packed\\['wqkv'\\]"):
        tgd._check_cuda_args(x_t, tgd.pack_decode_params(tgpt, torch.bfloat16), kv_t, 0, H)
    with pytest.raises(ValueError, match="contiguous"):
        tgd._check_cuda_args(x_t, packed, kv_t.transpose(1, 2).contiguous().transpose(1, 2),
                             0, H)
    with pytest.raises(ValueError, match="float32"):
        tgd._check_cuda_args(x_t.double(), packed, kv_t, 0, H)
    wide = 8192
    with pytest.raises(ValueError, match="up to 4096"):
        tgd._check_cuda_args(torch.empty(1, wide, device="meta"), packed,
                             torch.empty(1, 1, 2, 2 * wide, device="meta"), 0, 64)
    tgd._check_cuda_args(x_t, packed, kv_t, 3, H)


def test_phase_stamps_take_a_cuda_int64_buffer():
    """The profiling stamps of the persistent launch: start, the 8 barriers
    of each layer, end; any buffer but a contiguous int64 CUDA one is
    refused before the library is touched."""
    assert tgd.stamp_rows(12) == 98
    for bad in (torch.zeros(8, dtype=torch.int64), torch.zeros(8, dtype=torch.int32, device="meta")):
        with pytest.raises(ValueError, match="int64 CUDA"):
            tgd.record_phase_stamps(bad)

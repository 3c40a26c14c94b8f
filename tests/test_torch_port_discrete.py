"""The port's discrete VQ-diffusion sampler against the JAX package's: the
mask-and-replace schedule, ``q_pred`` and both posteriors, the plain version
of the fused posterior-and-sample kernel (against the Pallas kernel in
interpret mode and against the XLA path), the ``prng`` variant's Philox
stream and Gumbel transform, ``sample`` / ``sample_fast`` with the JAX
package's noise injected, the VQ_Official composite's ``predict_start`` on
transplanted U-Net weights, and the entry point on the CPU.

Every input is drawn with numpy from a seed and handed to both sides. Each
JAX reference runs under one ``jax.jit``; chains take 3 steps at the
small shapes of tests/test_discrete_posterior_pallas.py or the tiny
geometry of tests/conftest.py.

Tolerances: schedule, ``q_pred`` and the posteriors within 1e-5 (the same
f32 formulas, summed in other orders); ``predict_start`` within 1e-4 of
the JAX composite's (ShuffleNet units on a log-onehot input whose entries
are log 1e-30); sampled indices identical.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_shuffle import numpy_variables
from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.diffusion import discrete as td
from vq_vae_gan_diffusion_torch.diffusion.schedules import discrete_alpha_schedule
from vq_vae_gan_diffusion_torch.models.unet_shuffle import ShuffleUNet as TorchUNet
from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import (
    VQDiffusionComposite as TorchComposite)
from vq_vae_gan_diffusion_torch.ops import discrete_posterior as tp
from vq_vae_gan_diffusion_torch.weights import shuffle_unet_state_from_jax
from vq_vae_gan_diffusion_tpu.diffusion import discrete as jd
from vq_vae_gan_diffusion_tpu.diffusion import schedules as js
from vq_vae_gan_diffusion_tpu.models.unet_shuffle import ShuffleUNet as JaxUNet
from vq_vae_gan_diffusion_tpu.models.vq_diffusion_composite import (
    VQDiffusionComposite as JaxComposite)
from vq_vae_gan_diffusion_tpu.ops import discrete_posterior_pallas as jp


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more,
    and with every core busy (several test workers) a full thread pool makes
    the U-Net's convolutions run many times slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x, dtype=None) -> torch.Tensor:
    out = torch.from_numpy(np.array(x))
    return out if dtype is None else out.to(dtype)


def _gumbel_np(rs, shape) -> np.ndarray:
    """Gumbel noise as the JAX package transforms it, from numpy uniforms."""
    u = jnp.asarray(rs.uniform(size=shape).astype(np.float32))
    return np.array(-jnp.log(-jnp.log(u + 1e-30) + 1e-30))


@pytest.mark.parametrize("timesteps,k,ctt_T", [(12, 1025, 0.99999), (100, 1025, 0.9),
                                               (1000, 1024, 0.99999)])
def test_discrete_schedule_matches_jax(timesteps, k, ctt_T):
    for got, want in zip(discrete_alpha_schedule(timesteps, N=k - 1, ctt_T=ctt_T),
                         js.discrete_alpha_schedule(timesteps, N=k - 1, ctt_T=ctt_T)):
        np.testing.assert_array_equal(got, want)
    got = td.make_discrete_schedule(timesteps, k, ctt_T)
    want = jd.make_discrete_schedule(timesteps, k, ctt_T)
    for field in want._fields:
        g, w = getattr(got, field).numpy(), np.asarray(getattr(want, field))
        assert g.shape == w.shape, field
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5, err_msg=field)
    assert got.log_cumprod_at.shape == (timesteps + 1,)


def _pair(k, n, timesteps, **kw):
    return (jd.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=timesteps, **kw),
            td.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=timesteps, **kw))


def test_forward_and_posteriors_match_jax():
    """q_pred, the dense q_posterior (on a one-hot carry and on the chain
    init's log(U) noise) and q_posterior_idx, at t in {0, 1, T-1}."""
    b, n, k, T = 2, 16, 129, 10
    jdd, tdd = _pair(k, n, T)
    rs = np.random.RandomState(0)
    logits = (3 * rs.standard_normal((b, n, k))).astype(np.float32)
    log_x0 = np.array(jax.nn.log_softmax(jnp.asarray(logits), -1))
    x_t = rs.randint(0, k, (b, n)).astype(np.int32)
    x_t[:, :3] = k - 1                                    # masked positions
    log_noise = np.log(rs.uniform(size=(b, n, k))).astype(np.float32)

    @jax.jit
    def ref(log_x0, x_t, log_noise, t):
        onehot = jd.index_to_log_onehot(x_t, k)
        return (jdd.q_pred(log_x0, t), jdd.q_posterior(log_x0, onehot, t),
                jdd.q_posterior(log_x0, log_noise, t), jdd.q_posterior_idx(log_x0, x_t, t))

    for tv in (0, 1, T - 1):
        t = np.full((b,), tv, np.int32)
        want = ref(log_x0, x_t, log_noise, t)
        tt, lx0, xt = _t(t).long(), _t(log_x0), _t(x_t).long()
        got = (tdd.q_pred(lx0, tt), tdd.q_posterior(lx0, td.index_to_log_onehot(xt, k), tt),
               tdd.q_posterior(lx0, _t(log_noise), tt), tdd.q_posterior_idx(lx0, xt, tt))
        for name, g, w in zip(("q_pred", "q_posterior", "q_posterior(noise)",
                               "q_posterior_idx"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5,
                                       err_msg=f"{name} t={tv}")


@pytest.mark.parametrize("b,n,k,T,rate", [(3, 16, 1025, 12, 0.86), (2, 49, 257, 8, 0.5)])
def test_plain_kernel_matches_pallas_and_xla(b, n, k, T, rate):
    """The plain B6 body gives the Pallas kernel's indices (interpret mode)
    and the XLA path's, with the same Gumbel noise, at trunc_k 0 and > 0,
    on carries with masked positions, at t in {0, 1, T-1}; the CPU wrapper
    is the plain version."""
    jdd, tdd = _pair(k, n, T, truncation_rate=rate)
    rs = np.random.RandomState(1)
    logits = (3 * rs.standard_normal((b, n, k - 1))).astype(np.float32)
    x_t = rs.randint(0, k, (b, n)).astype(np.int32)
    x_t[0, :4] = k - 1
    gumbel = _gumbel_np(rs, (b, n, k))
    trunc = max(int(k * rate), 1)

    @jax.jit
    def xla(logits, x_t, t, gumbel):
        ev = jdd.q_posterior_idx(jdd._log_pred_from_logits(logits), x_t, t)
        kth = jax.lax.top_k(ev, trunc)[0][..., -1:]
        return (jnp.argmax(gumbel + ev, -1),
                jnp.argmax(gumbel + jnp.where(ev < kth, -jnp.inf, ev), -1))

    for tv in (0, 1, T - 1):
        t = np.full((b,), tv, np.int32)
        coefs = jp.gather_posterior_coefs(jdd.sched, jnp.asarray(t), T)
        t_coefs = tp.gather_posterior_coefs(tdd._s("cpu"), _t(t).long(), T)
        np.testing.assert_array_equal(t_coefs.numpy(), np.asarray(coefs)[:, :10])
        xla_idx = xla(logits, x_t, t, gumbel)
        for trunc_k, want_xla in ((0, xla_idx[0]), (trunc, xla_idx[1])):
            want = np.asarray(jp.fused_posterior_sample(
                jnp.asarray(logits), jnp.asarray(x_t), coefs, jnp.asarray(gumbel),
                interpret=True, trunc_k=trunc_k))
            got = tp.fused_posterior_sample(_t(logits), _t(x_t).long(), t_coefs, _t(gumbel),
                                            trunc_k=trunc_k)
            assert got.dtype == torch.int64 and tuple(got.shape) == (b, n)
            np.testing.assert_array_equal(got.numpy(), want, err_msg=f"t={tv} trunc={trunc_k}")
            np.testing.assert_array_equal(got.numpy(), np.asarray(want_xla),
                                          err_msg=f"xla t={tv} trunc={trunc_k}")


def test_gumbel_from_bits_matches_jax():
    bits = np.random.default_rng(0).integers(0, 2 ** 32, size=(50_000,), dtype=np.uint64)
    want = np.asarray(jp._gumbel_from_bits(jnp.asarray(bits.astype(np.uint32))))
    got = tp.gumbel_from_bits(_t(bits.astype(np.int64)))
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("counter,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
    ((0xffffffff,) * 4, (0xffffffff,) * 2, (0x408f276d, 0x41c83b0e, 0xa20bc7c6, 0x6d5451fd)),
    ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
     (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1)),
])
def test_philox_known_answers(counter, key, want):
    """Philox4x32-10 against the Random123 known-answer vectors."""
    words = tp.philox4x32(tuple(torch.tensor(c) for c in counter),
                          tuple(torch.tensor(k) for k in key))
    assert tuple(int(w) for w in words) == want


def test_philox_bits_layout_and_prng_route():
    """Word c % 4 at counter (c // 4, n, 0, 0), key (seeds[b, 0], seeds[b, 1])
    as uint32; the prng route's CPU wrapper samples with those bits."""
    seeds = torch.tensor([[7, -3], [2 ** 31 - 1, -2 ** 31]], dtype=torch.int32)
    bits = tp.philox_bits(seeds, 3, 10)
    assert tuple(bits.shape) == (2, 3, 10)
    for b, n, c in ((0, 0, 0), (0, 2, 9), (1, 1, 5), (1, 2, 3)):
        key = tuple(torch.tensor(int(s) & 0xFFFFFFFF) for s in seeds[b])
        words = tp.philox4x32((torch.tensor(c // 4), torch.tensor(n), torch.tensor(0),
                               torch.tensor(0)), key)
        assert int(bits[b, n, c]) == int(words[c % 4])
    rs = np.random.RandomState(2)
    logits, x_t = _t(rs.standard_normal((2, 3, 9)).astype(np.float32)), torch.tensor(
        [[0, 9, 4], [3, 3, 9]])
    coefs = tp.gather_posterior_coefs(td.make_discrete_schedule(6, 10), torch.tensor([3, 0]), 6)
    want = tp.reference_posterior_sample(logits, x_t, coefs, tp.gumbel_from_bits(bits), 4)
    assert torch.equal(tp.fused_posterior_sample_prng(logits, x_t, coefs, seeds, 4), want)


def test_prng_route_samples_the_posterior():
    """The prng stream's samples follow softmax(ev): 16,384 draws of one
    row's posterior over 17 classes, total variation below 0.03."""
    k, n, b = 17, 256, 64
    rs = np.random.RandomState(3)
    logits = _t(np.broadcast_to(rs.standard_normal((1, 1, k - 1)), (b, n, k - 1))
                .astype(np.float32)).contiguous()
    x_t = torch.full((b, n), 5)
    coefs = tp.gather_posterior_coefs(td.make_discrete_schedule(10, k),
                                      torch.full((b,), 4), 10)
    seeds = torch.from_numpy(rs.randint(-2 ** 31, 2 ** 31, (b, 2)).astype(np.int32))
    got = tp.fused_posterior_sample_prng(logits, x_t, coefs, seeds)
    p = torch.exp(tp.posterior_log_probs(logits[:1, :1], x_t[:1, :1], coefs[:1]))[0, 0]
    hist = torch.bincount(got.flatten(), minlength=k).double() / got.numel()
    assert 0.5 * (hist - p / p.sum()).abs().sum().item() < 0.03


def _jax_noise(rng, shape, steps, init: bool = True):
    """The noise DiscreteDiffusion.sample / sample_fast draw from ``rng``:
    the chain-init uniform, then one Gumbel tensor a step (the dense first
    step's, then each structured step's)."""
    rng_init, rng_loop = jax.random.split(rng)
    u = np.array(jax.random.uniform(rng_init, shape)) if init else None
    gumbel = []
    for _ in range(steps):
        rng_loop, sub = jax.random.split(rng_loop)
        gumbel.append(_t(jd.DiscreteDiffusion._gumbel(sub, shape)))
    return (None if u is None else _t(u)), gumbel


def _model_fns(k):
    """The same index-native denoiser on both sides: row argmax(x) of a fixed
    table, plus 0.1 t (a gather and one f32 add, bit-identical)."""
    table = np.random.RandomState(4).standard_normal((k, k - 1)).astype(np.float32)
    jt, tt = jnp.asarray(table), _t(table)

    def j_fn(log_x, t):
        return jt[jnp.argmax(log_x, -1)] + 0.1 * t[:, None, None].astype(jnp.float32)

    def t_fn(log_x, t):
        return tt[log_x.argmax(-1)] + 0.1 * t[:, None, None].float()
    return j_fn, t_fn


@pytest.mark.parametrize("method,kwargs,steps", [
    ("sample", {}, 3), ("sample_fast", {"skip_step": 2}, 6)])
def test_sample_matches_jax(method, kwargs, steps):
    """3 reverse steps (the dense chain-init step, then structured ones), by
    the plain-ops route and the fused route (plain kernel on the CPU), give
    the JAX XLA path's indices with its noise injected. sample_fast runs
    t = 5, 2, 0 with its t_post."""
    k, n, b, T = 65, 16, 2, 6
    jdd = jd.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T, sampling_timesteps=steps)
    tdd = td.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T, sampling_timesteps=steps)
    jdd.model_fn, tdd.model_fn = _model_fns(k)
    rng = jax.random.PRNGKey(5)
    want = np.asarray(jax.jit(lambda r: getattr(jdd, method)(r, batch_size=b, **kwargs))(rng))
    u, gumbel = _jax_noise(rng, (b, n, k), 3)
    for fused in (False, True):
        tdd.fused_posterior = fused
        got = getattr(tdd, method)(b, init_uniform=u, step_gumbel=gumbel, **kwargs)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"fused_posterior={fused}")


def test_posterior_mode():
    for mode in (True, "on", "true", "interpret", 1):
        assert td.posterior_mode(mode) is True
    for mode in (False, "off", None, 0, ""):
        assert td.posterior_mode(mode) is False
    assert td.posterior_mode("prng") == "prng"


def test_prior_chain_init_is_flat():
    """chain_init 'prior' reads the padding entry at index -1: every class,
    the mask class included, starts at log(1e-30)."""
    d = td.DiscreteDiffusion(num_classes=9, seq_len=4, timesteps=5, chain_init="prior")
    log_z = d._chain_init(2, None, torch.device("cpu"))
    want = np.asarray(jd.DiscreteDiffusion(num_classes=9, seq_len=4, timesteps=5,
                                           chain_init="prior")._chain_init(None, 2))
    np.testing.assert_array_equal(log_z.numpy(), want)
    assert float(log_z.max()) == float(log_z.min()) == np.float32(np.log(1e-30))


def test_filmstrip_not_ported():
    """The sampling filmstrip, refused until ROADMAP A4 ported it: with
    ``return_all_timesteps`` the sampler returns the indices and each of the
    5 steps' [B, 5, N], identical to the JAX sampler's with its noise
    injected."""
    k, n, b, T = 9, 4, 2, 5
    jdd = jd.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T)
    tdd = td.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T)
    jdd.model_fn, tdd.model_fn = _model_fns(k)
    rng = jax.random.PRNGKey(8)
    want_idx, want = jax.jit(lambda r: jdd.sample(r, b, return_all_timesteps=True))(rng)
    u, gumbel = _jax_noise(rng, (b, n, k), T)
    idx, frames = tdd.sample(b, init_uniform=u, step_gumbel=gumbel, return_all_timesteps=True)
    assert tuple(frames.shape) == (b, T, n)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(want))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))


def _vqofficial(tiny_config, log_dir=None, **overrides) -> dict:
    """tiny_config with the VQ_Official prior: K 32 classes over N 16 tokens
    (latent 4x4), 10 diffusion steps, 3 sampled."""
    data = tiny_config.to_dict()
    data["architecture"]["model_name"] = "vqdiffusion"
    data["architecture"]["vqvae"].update({"num_codebook_vectors": 32, "latent_size": 4,
                                          "intermediate_channels": [16, 32, 32, 32]})
    data["architecture"]["vqdiffusion"].update({"diffusion_type": "VQ_Official",
                                                "diffusion_steps": 10, "sampling_steps": 3,
                                                "fused_sampler": "packed", **overrides})
    if log_dir is not None:
        data["trainer"]["log_dir"] = str(log_dir)
    return data


def test_vqofficial_predict_start_matches_jax(tiny_config):
    """Both composites build the VQ_Official U-Net at base 64, mults (1, 2,
    4, 8), whatever the config says. Then one predict_start (the [B, N, K]
    log-onehot carry as a [B, K, N, 1] image, the U-Net, the last row
    dropped, log-softmax, mask pad, clamp) on transplanted weights, by the
    port's folded kernel route and its module route. For that comparison
    both composites get the same one-level U-Net (base 16): the adapter and
    the transplant are the same at any width (the weight map is checked key
    for key in tests/test_torch_port_vqdiffusion.py), and the JAX compile of
    the full U-Net would cost most of this file's time."""
    data = _vqofficial(tiny_config, fused_sampler=False, unet_base_dim=16,
                       unet_dim_mults=[1])
    jcomp = JaxComposite(tiny_config.__class__(data))
    port_unet = TorchComposite(t_config_from_dict(data)).unet
    assert (jcomp.unet.base_dim, tuple(jcomp.unet.dim_mults)) == (64, (1, 2, 4, 8))
    assert port_unet.init_conv.module[0].out_channels == 64
    assert [b.conv1.branch1[2].module[0].out_channels * 2
            for b in port_unet.encoder_blocks] == [64, 128, 256, 512]
    k, n = jcomp.codebook_size, jcomp.seq_len

    jcomp.unet = JaxUNet(jcomp.timesteps, 256, 1, 1, 16, (1,))
    variables = jax.tree_util.tree_map(jnp.asarray, numpy_variables(
        jcomp.unet, 6, jnp.zeros((1, k, n, 1)), None, jnp.zeros((1,), jnp.int32)))
    rs = np.random.RandomState(7)
    x_idx = rs.randint(0, k, (2, n)).astype(np.int32)
    t = np.array([9, 2], np.int32)

    @jax.jit
    def ref(params, stats, x_idx, t):
        jcomp.prior.model_fn = jcomp._bind(params, stats)
        return jcomp.prior.predict_start(jd.index_to_log_onehot(x_idx, k), t)
    want = np.asarray(ref(variables["params"], variables["batch_stats"], x_idx, t))
    for fused in (True, False):
        port = TorchComposite(t_config_from_dict(_vqofficial(tiny_config, fused_sampler=fused)))
        port.unet = TorchUNet(port.timesteps, 256, 1, 1, 16, (1,))
        port.unet.load_state_dict(shuffle_unet_state_from_jax(variables["params"],
                                                              variables["batch_stats"]))
        prior = port.eval().bind()
        with torch.no_grad():
            got = prior.predict_start(td.index_to_log_onehot(_t(x_idx).long(), k), _t(t).long())
        assert tuple(got.shape) == (2, n, k)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4,
                                   err_msg=f"fused_sampler={fused}")


def _write_config(tmp_path, tiny_config) -> str:
    path = tmp_path / "tiny_vqofficial.yml"
    path.write_text(yaml.safe_dump(_vqofficial(tiny_config, tmp_path / "logs")))
    return str(path)


def test_generate_vqofficial_on_cpu(tmp_path, tiny_config):
    """The entry point on the discrete prior: a grid, indices in the
    codebook, finite images; --fused-posterior on and off sample the same
    indices from the same seed, and prng runs."""
    cfg_path = _write_config(tmp_path, tiny_config)
    outs = {}
    for mode in ("on", "off", "prng"):
        outs[mode] = generate.run(["--config", cfg_path, "--n-samples", "2", "--device", "cpu",
                                   "--fused-posterior", mode])
        idx, images = outs[mode]["indices"], outs[mode]["images"]
        assert tuple(idx.shape) == (2, 16) and 0 <= int(idx.min()) and int(idx.max()) < 32
        assert tuple(images.shape) == (2, 32, 32, 3) and torch.isfinite(images).all()
        assert outs[mode]["path"] in glob.glob(str(
            tmp_path / "logs" / "*" / "vqdiffusion_generate" / "run_*" / "samples_epoch0.jpg"))
    assert torch.equal(outs["on"]["indices"], outs["off"]["indices"])


def test_generate_vqofficial_without_gpu_raises(tmp_path, tiny_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--config", _write_config(tmp_path, tiny_config), "--n-samples", "2"])


def test_vqofficial_config_is_the_gaussian3d_config_with_two_changes():
    def load(path):
        with open(path) as f:
            return yaml.safe_load(f)
    got, base = load("configs/inference_config_vqofficial.yml"), load(
        "configs/inference_config_vqdiffusion.yml")
    base["architecture"]["vqdiffusion"].update({"diffusion_type": "VQ_Official",
                                                "fused_posterior": True})
    assert got == base


def test_wrapper_rejects_bad_arguments():
    """The checks that guard the CUDA kernel raise on what it does not take;
    a device other than cuda or cpu raises before any check."""
    b, n, k = 2, 3, 10
    logits, x_t = torch.zeros(b, n, k - 1), torch.zeros(b, n, dtype=torch.long)
    coefs, gumbel = torch.zeros(b, 10), torch.zeros(b, n, k)

    def check(logits=logits, x_t=x_t, coefs=coefs, noise=gumbel, trunc_k=0):
        return tp._check(logits, x_t, coefs, noise, "gumbel", (b, n, k), torch.float32, trunc_k)
    assert check(x_t=x_t.int()).dtype == torch.int64
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        check(logits=logits.double())
    wide = tp.MAX_CLASSES + 1
    with pytest.raises(ValueError, match=f"at most {tp.MAX_CLASSES}"):
        tp._check(torch.zeros(1, 1, wide - 1), torch.zeros(1, 1, dtype=torch.long),
                  torch.zeros(1, 10), torch.zeros(1, 1, wide), "gumbel", (1, 1, wide),
                  torch.float32, 0)
    with pytest.raises(ValueError, match="trunc_k"):
        check(trunc_k=k + 1)
    with pytest.raises(ValueError, match="x_t must be"):
        check(x_t=x_t.float())
    with pytest.raises(ValueError, match="coefs must be"):
        check(coefs=torch.zeros(b, 16))
    with pytest.raises(ValueError, match="gumbel must be"):
        check(noise=torch.zeros(b, n, k - 1))
    with pytest.raises(ValueError, match="contiguous"):
        check(logits=torch.zeros(b, k - 1, n).transpose(1, 2))
    meta = torch.zeros(b, n, k - 1, device="meta")
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tp.fused_posterior_sample(meta, x_t, coefs, gumbel)
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        tp.fused_posterior_sample_prng(meta, x_t, coefs, torch.zeros(b, 2, dtype=torch.int32))


@pytest.mark.parametrize("n,k", [(1, 2 ** 20), (1, 2 ** 20 + 1), (256, 2049), (256, 4096),
                                 (256, 4097), (512, 2048), (512, 2049), (1024, 1024),
                                 (1024, 1025), (16, 1024)])
def test_kernel_route_is_fits_vmem(n, k):
    """The port's sampler takes its kernel at exactly the shapes where the
    JAX sampler takes its Pallas kernel."""
    assert tp.fits_kernel_route(n, k) == jp.fits_vmem(n, k)


def _counting(monkeypatch, calls: dict) -> None:
    """Count each posterior wrapper's calls from the sampler, each still
    running its plain version on the CPU."""
    for name in ("fused_posterior_sample", "fused_posterior_sample_prng"):
        def spy(*args, _fn=getattr(td, name), _name=name, **kwargs):
            calls[_name] += 1
            return _fn(*args, **kwargs)
        calls[name] = 0
        monkeypatch.setattr(td, name, spy)


@pytest.mark.parametrize("method,kwargs,steps", [
    ("sample", {}, 3), ("sample_fast", {"skip_step": 2}, 6)])
def test_wide_rows_take_the_kernel_as_jax_does(monkeypatch, method, kwargs, steps):
    """K = 2049 (a transformer prior on a 2048-code VQVAE) over 256
    positions fits the JAX kernel's budget, so both samplers take their
    kernel: the JAX one the Pallas kernel (interpreted on the CPU), the port
    its wrapper (the plain version on the CPU), one call a structured step,
    with the same indices from the same noise."""
    k, n, b, T = 2049, 256, 2, 6
    assert jp.fits_vmem(n, k) and tp.fits_kernel_route(n, k)
    jdd = jd.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T, sampling_timesteps=steps)
    tdd = td.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T, sampling_timesteps=steps)
    jdd.model_fn, tdd.model_fn = _model_fns(k)
    jdd.fused_posterior = tdd.fused_posterior = True
    rng = jax.random.PRNGKey(6)
    want = np.asarray(jax.jit(lambda r: getattr(jdd, method)(r, batch_size=b, **kwargs))(rng))
    u, gumbel = _jax_noise(rng, (b, n, k), 3)
    calls = {}
    _counting(monkeypatch, calls)
    got = getattr(tdd, method)(b, init_uniform=u, step_gumbel=gumbel, **kwargs)
    np.testing.assert_array_equal(got.numpy(), want)
    assert calls == {"fused_posterior_sample": 2, "fused_posterior_sample_prng": 0}


@pytest.mark.parametrize("method", ["sample", "fast_sample"])
def test_wide_prior_routes_past_the_kernel(monkeypatch, method):
    """A transformer prior on a 2048-code VQVAE (K = 2049) over a 32x32
    grid, 1024 positions, is past the JAX kernel's budget (fits_vmem), so
    under fused_posterior on and prng it samples with both wrappers
    raising, as the JAX sampler takes XLA ops there: 'on' gives the plain
    route's indices on the same generator; 'prng' gives the plain route's
    indices with its Philox noise injected (recorded from the run's
    seeds)."""
    from vq_vae_gan_diffusion_torch.models.transformer_vq_diffusion import (
        TransformerVQDiffusion as TorchTVQ)

    def refuse(*args, **kwargs):
        raise AssertionError("a posterior wrapper was called past fits_vmem")
    monkeypatch.setattr(td, "fused_posterior_sample", refuse)
    monkeypatch.setattr(td, "fused_posterior_sample_prng", refuse)
    n = 1024
    tm = TorchTVQ(codebook_size=2048, seq_len=n, diffusion_steps=5, embedding_dim=16,
                  num_layers=1, num_heads=2)
    assert tm.num_classes == 2049
    assert not jp.fits_vmem(n, tm.num_classes) and not tp.fits_kernel_route(n, tm.num_classes)
    tm.predictor.init_weights(torch.Generator().manual_seed(0))
    run = getattr(tm, method)

    def sample(fused, **kwargs):
        tm.diffusion.fused_posterior = fused
        return run(2, **kwargs)

    plain = sample(False, generator=torch.Generator().manual_seed(1))
    on = sample(True, generator=torch.Generator().manual_seed(1))
    assert torch.equal(on, plain)

    noise = []
    draw = td.DiscreteDiffusion._noise

    def record(self, *args, **kwargs):
        noise.append(draw(self, *args, **kwargs))
        return noise[-1]
    monkeypatch.setattr(td.DiscreteDiffusion, "_noise", record)
    prng = sample("prng", generator=torch.Generator().manual_seed(1))
    monkeypatch.setattr(td.DiscreteDiffusion, "_noise", draw)
    assert noise[0].dtype == torch.float32 and all(s.dtype == torch.int32 for s in noise[1:])
    gumbel = [noise[0]] + [tp.gumbel_from_bits(tp.philox_bits(s, n, tm.num_classes))
                           for s in noise[1:]]
    assert tuple(prng.shape) == (2, 32, 32)
    assert 0 <= int(prng.min()) and int(prng.max()) <= 2047
    assert torch.equal(prng, sample(False, step_gumbel=gumbel))

"""The port's discrete VQ-diffusion training against the JAX package's:
``DiscreteDiffusion.train_loss`` and its importance sampling, the
transformer prior's loss, the VQ_Official composite's loss and worker,
the sampling filmstrip, the CLIs and the demo on the CPU.

The JAX draws of a loss (t from ``sample_time`` on the first half of the
key, the Gumbel noise of q(x_t | x_0) on the second) are rebuilt from the
same key and injected. Geometry: K = 33 classes over 16 positions for the
process alone; tests/conftest.py::tiny_config with a 32-code VQVAE at
latent 4 (K = 32 over 16 positions) for VQ_Official, whose U-Net both
composites build at base 64, mults (1, 2, 4, 8) and which these tests
shrink to base 16, mults (1,) on both sides (the adapter and the transplant
are the same at any width; the weight map is checked key for key in
tests/test_torch_port_vqdiffusion.py); the transformer prior at K = 65 over
64 positions, width 32, 2 blocks.

Tolerances: the loss and its metrics within 1e-5 relative (1e-4 through the
VQ_Official U-Net in train mode, whose output lies within 1e-4 of flax's);
the new
``LtState`` within 1e-6 (the history relative, the accuracy EMAs absolute,
the counts equal); gradients leaf by leaf within 1e-5 of each leaf's
largest entry (the VQ_Official U-Net's in float64, under the f32 loss's
cotangent); sampled indices
identical; the worker's parameters within 2 lr a step and, where more than
lr / 10 apart, explained by an f32 gradient within rounding of zero
(assert_params_explained), its running statistics within 1e-4 plus 2e-3 of
a leaf's largest entry (STATS_RTOL says why).
"""

import functools
import json
import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_discrete import _jax_noise, _model_fns, _vqofficial
from test_torch_port_shuffle import numpy_variables
from test_torch_port_tvqdiff import GEOMETRY, _numpy_params
from test_torch_port_vqd_train import ROUNDING, _unet_state, assert_params_close
from vq_vae_gan_diffusion_torch import generate, vq_diffusion
from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.diffusion import discrete as td
from vq_vae_gan_diffusion_torch.models import transformer_vq_diffusion as t_tvq_mod
from vq_vae_gan_diffusion_torch.models import vq_diffusion_composite as t_comp_mod
from vq_vae_gan_diffusion_torch.models.transformer_vq_diffusion import (
    TransformerVQDiffusion as TorchTVQ)
from vq_vae_gan_diffusion_torch.models.unet_shuffle import ShuffleUNet as TorchUNet
from vq_vae_gan_diffusion_torch.train import cli
from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker as TorchWorker
from vq_vae_gan_diffusion_tpu.diffusion import discrete as jd
from vq_vae_gan_diffusion_tpu.models import vq_diffusion_composite as j_comp_mod
from vq_vae_gan_diffusion_tpu.models.transformer_vq_diffusion import (
    TransformerVQDiffusion as JaxTVQ)
from vq_vae_gan_diffusion_tpu.models.unet_shuffle import ShuffleUNet as JaxUNet
from vq_vae_gan_diffusion_tpu.train.vq_diffusion_worker import VQDiffusionWorker as JaxWorker

STEPS, BATCH, ITERS = 3, 4, 5
# the VQ_Official loss through the U-Net in train mode: its output lies
# within 1e-4 of flax's (tests/test_torch_port_vqd_train.py), and the loss
# sums the KL over the batch's positions of the logits' log-softmax
UNET_RTOL = 1e-4
# the history holds each sample's squared loss: one sample's KL, not the
# batch's mean, within 2e-4, its square within 4e-4
HISTORY_RTOL = 4 * UNET_RTOL
# the running statistics: the init conv's output on the log-onehot image
# (entries -69 and 0) has a batch mean near 130 against a variance near
# 700, and flax's E[x^2] - E[x]^2 in f32 loses about 1e-3 of that variance
# to rounding (the port takes the mean squared deviation): within 1e-4 plus
# 2e-3 of each leaf's largest entry
STATS_RTOL = 2e-3
# f32 rounding of the U-Net's gradients: the two sides' f32 gradients lie
# up to 5e-3 of a leaf's largest entry apart (their float64 ones agree,
# test_vqofficial_loss_and_gradients_match_jax); twice that
GRAD_F32 = 1e-2


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def jax_draws(prior, rng, b: int, lt):
    """The t and Gumbel noise ``jd.DiscreteDiffusion.train_loss(rng, x0 [b, N],
    lt)`` draws."""
    rng_t, rng_q = jax.random.split(rng)
    t, _ = prior.sample_time(rng_t, b, lt)
    gumbel = prior._gumbel(rng_q, (b, prior.seq_len, prior.num_classes))
    return _t(t).long(), _t(gumbel)


def lt_to_jax(lt: td.LtState) -> jd.LtState:
    return jd.LtState(*(jnp.asarray(v.numpy()) for v in lt))


def lt_to_torch(lt: jd.LtState) -> td.LtState:
    return td.LtState(*(_t(v) for v in lt))


def assert_lt_close(got: td.LtState, want: jd.LtState, what: str = "",
                    rtol: float = 1e-6) -> None:
    """The history within ``rtol`` (it holds squared losses), the accuracy
    EMAs within 1e-6, the counts equal."""
    want = lt_to_torch(want)
    torch.testing.assert_close(got.Lt_history, want.Lt_history, rtol=rtol, atol=1e-6,
                               msg=f"{what} Lt_history")
    for field in ("acc_ema", "keep_ema"):
        torch.testing.assert_close(getattr(got, field), getattr(want, field), rtol=0,
                                   atol=1e-6, msg=f"{what} {field}")
    assert torch.equal(got.Lt_count, want.Lt_count), f"{what} Lt_count"


def random_lt(rs, timesteps: int, warm: bool) -> td.LtState:
    """A history of positive losses; counts past 10 everywhere when warm,
    else one count at 10."""
    count = rs.randint(11, 30, timesteps).astype(np.float32)
    if not warm:
        count[rs.randint(timesteps)] = 10
    return td.LtState(*(torch.from_numpy(v.astype(np.float32)) for v in (
        rs.uniform(0, 400, timesteps), count, rs.uniform(0, 1, timesteps),
        rs.uniform(0, 1, timesteps))))


# -- the process ---------------------------------------------------------------------------

PROCESS = {
    "vq_official": {},
    "transformer": dict(auxiliary_loss_weight=5e-4, adaptive_auxiliary_loss=True,
                        mask_weight=(1.5, 1.0), ctt_T=0.9, mask_logit_pad=-30.0,
                        use_importance_sampling=False),
}


@pytest.mark.parametrize("history", ["empty", "cold", "warm"])
@pytest.mark.parametrize("kind", sorted(PROCESS))
def test_train_loss_matches_jax(kind, history):
    """train_loss on the same x0 and denoiser with JAX's draws of three keys
    injected: the loss, its metrics and the new LtState. 8 rows over 6 steps
    draw equal t's, whose scatters the last of them wins on both sides;
    "warm" (every count past 10) draws t by importance, "cold" (one count at
    10) uniformly."""
    k, n, b, T = 33, 16, 8, 6
    jp = jd.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T, **PROCESS[kind])
    tp = td.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T, **PROCESS[kind])
    jp.model_fn, tp.model_fn = _model_fns(k)
    rs = np.random.RandomState(0)
    x0 = rs.randint(0, k - 1, (b, n))
    x0[:, :3] = k - 1                                   # masked tokens in x0 too
    lt = td.LtState.init(T) if history == "empty" else random_lt(rs, T, history == "warm")
    loss_fn = jax.jit(jp.train_loss)
    for seed in range(3):
        rng = jax.random.PRNGKey(seed)
        want, want_metrics, want_lt = loss_fn(rng, jnp.asarray(x0), lt_to_jax(lt))
        t, gumbel = jax_draws(jp, rng, b, lt_to_jax(lt))
        got, got_metrics, got_lt = tp.train_loss(_t(x0).long(), lt, t=t, gumbel=gumbel)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, err_msg=f"seed {seed}")
        assert set(got_metrics) == set(want_metrics) == {"vb_loss", "kl", "decoder_nll"}
        for name in want_metrics:
            np.testing.assert_allclose(float(got_metrics[name]), float(want_metrics[name]),
                                       rtol=1e-5, err_msg=f"seed {seed} {name}")
        assert_lt_close(got_lt, want_lt, f"seed {seed}")
        assert len(set(t.tolist())) < b
        if history == "warm" and kind == "vq_official":
            uniform = jax.random.randint(jax.random.split(jax.random.split(rng)[0])[0], (b,),
                                         0, T)
            assert t.tolist() != np.asarray(uniform).tolist()


def test_sample_time_rule():
    """The port's own draws: uniform t while cold, t from sqrt(Lt) with
    pt[0] = pt[1] when warm, on the generator's device."""
    T, b = 6, 4000
    d = td.DiscreteDiffusion(num_classes=9, seq_len=4, timesteps=T)
    rs = np.random.RandomState(1)
    lt = random_lt(rs, T, warm=True)
    gen = torch.Generator().manual_seed(0)
    t, pt = d.sample_time(b, lt, gen)
    want = torch.sqrt(lt.Lt_history + 1e-10) + 1e-4
    want[0] = want[1]
    want = want / want.sum()
    assert torch.equal(pt, want[t])
    freq = torch.bincount(t, minlength=T).double() / b
    assert (freq - want.double()).abs().max() < 0.03
    cold = lt._replace(Lt_count=lt.Lt_count.clone().fill_(10))
    t, pt = d.sample_time(b, cold, gen)
    assert torch.equal(pt, torch.full((b,), 1.0 / T))


def test_q_sample_matches_jax():
    k, n, b, T = 33, 16, 3, 6
    jp = jd.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T)
    tp = td.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T)
    x0 = np.random.RandomState(2).randint(0, k, (b, n))
    t = np.array([0, 3, 5], np.int32)
    rng = jax.random.PRNGKey(3)
    want = jax.jit(jp.q_sample)(rng, jd.index_to_log_onehot(jnp.asarray(x0), k), t)
    got = tp.q_sample(td.index_to_log_onehot(_t(x0), k), _t(t).long(),
                      _t(jp._gumbel(rng, (b, n, k))))
    assert torch.equal(got, _t(want))


@pytest.mark.parametrize("fused", [False, True])
def test_filmstrip_matches_jax(fused):
    """return_all_timesteps: the indices after each of the 4 reverse steps
    [B, 4, N], identical to JAX's with its noise injected, by plain ops and
    by the fused route (its plain version on the CPU); the last frame is the
    sample."""
    k, n, b, T = 65, 16, 2, 6
    jp = jd.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T, sampling_timesteps=4)
    tp = td.DiscreteDiffusion(num_classes=k, seq_len=n, timesteps=T, sampling_timesteps=4)
    jp.model_fn, tp.model_fn = _model_fns(k)
    tp.fused_posterior = fused
    rng = jax.random.PRNGKey(9)
    want_idx, want_frames = jax.jit(lambda r: jp.sample(r, b, return_all_timesteps=True))(rng)
    u, gumbel = _jax_noise(rng, (b, n, k), 4)
    idx, frames = tp.sample(b, init_uniform=u, step_gumbel=gumbel, return_all_timesteps=True)
    assert tuple(frames.shape) == (b, 4, n)
    np.testing.assert_array_equal(frames.numpy(), np.asarray(want_frames))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(want_idx))
    assert torch.equal(frames[:, -1], idx)


# -- the transformer prior ------------------------------------------------------------------

def _grads_close(got: dict, want: dict, tol: float = 1e-5) -> None:
    """Each leaf whose gradient is above rounding (ROUNDING of the largest
    entry of all) within ``tol`` of the leaf's largest entry; the others (a
    key projection's bias, which softmax cancels; a conv bias ahead of a
    BatchNorm) within ROUNDING of the largest entry of all."""
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    live = 0
    for k in want:
        scale = float(want[k].abs().max())
        err = float((got[k] - want[k]).abs().max())
        if scale > ROUNDING * top:
            live += 1
            assert err <= tol * scale, f"{k}: {err:.3e} of {scale:.3e}"
        else:
            assert err <= ROUNDING * top, f"{k}: {err:.3e} of the largest {top:.3e}"
    assert live > len(want) / 2


def test_transformer_loss_and_gradients_match_jax(monkeypatch):
    """The transformer prior's loss with dropout off (the JAX denoiser bound
    without a dropout key), its metrics and LtState, and the predictor's
    gradients leaf by leaf."""
    jm = JaxTVQ(diffusion_steps=8, **GEOMETRY)
    params = _numpy_params(jm, 5)
    monkeypatch.setattr(t_tvq_mod, "DROPOUT", 0.0)
    tm = TorchTVQ(diffusion_steps=8, **GEOMETRY)
    tm.predictor.load_state_dict(W.transformer_predictor_state_from_jax(
        jax.tree_util.tree_map(np.asarray, params)), strict=True)
    rs = np.random.RandomState(6)
    x0 = rs.randint(0, 64, (3, 64))
    lt = td.LtState.init(8)
    rng = jax.random.PRNGKey(7)

    @jax.jit
    def ref(params, x0, rng):
        def loss_fn(p):
            jm.diffusion.model_fn = jm._bind(p)
            loss, metrics, new_lt = jm.diffusion.train_loss(rng, x0, lt_to_jax(lt))
            return loss, (metrics, new_lt)
        return jax.value_and_grad(loss_fn, has_aux=True)(params)
    (want, (want_metrics, want_lt)), grads = ref(params, jnp.asarray(x0), rng)
    t, gumbel = jax_draws(jm.diffusion, rng, 3, lt_to_jax(lt))
    got, got_metrics, got_lt = tm.loss(_t(x0).long(), lt, t=t, gumbel=gumbel)
    got.backward()
    got = got.detach()
    assert tm.predictor.training
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    for name in want_metrics:
        np.testing.assert_allclose(float(got_metrics[name]), float(want_metrics[name]),
                                   rtol=1e-5, err_msg=name)
    assert_lt_close(got_lt, want_lt)
    want_grads = W.transformer_predictor_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                               grads))
    _grads_close({k: p.grad for k, p in tm.predictor.named_parameters()}, want_grads)


def test_transformer_dropout_acts_in_train_mode_only():
    """Dropout 0.1 changes the logits in train mode, not in eval mode; the
    samplers run the predictor in eval mode."""
    tm = TorchTVQ(diffusion_steps=8, **GEOMETRY)
    tm.predictor.init_weights(torch.Generator().manual_seed(0))
    idx, t = torch.randint(0, 65, (2, 64)), torch.tensor([1, 5])
    tm.predictor.eval()
    with torch.no_grad():
        ref = tm.predictor(idx, t)
        assert torch.equal(tm.predictor(idx, t), ref)
        tm.predictor.train()
        torch.manual_seed(0)
        assert not torch.equal(tm.predictor(idx, t), ref)
    tm.sample(1, generator=torch.Generator().manual_seed(1))
    assert not tm.predictor.training


# -- VQ_Official -------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_unets():
    """Both composites build the VQ_Official U-Net at base 16, mults (1,)."""
    with pytest.MonkeyPatch.context() as mp:
        for mod in (j_comp_mod, t_comp_mod):
            full = mod.ShuffleUNet
            mp.setattr(mod, "ShuffleUNet",
                       lambda T, emb, c_in, c_out, base, mults, _f=full, **kw:
                       _f(T, emb, c_in, c_out, 16, (1,), **kw))
        yield


def _vqo_config(tiny_config, **overrides):
    return tiny_config.__class__(_vqofficial(tiny_config, **overrides))


def test_vqofficial_loss_and_gradients_match_jax(tiny_config, small_unets):
    """The composite's loss on images: the frozen VQVAE's indices, the U-Net
    in train mode on the [B, K, N, 1] log-onehot image; the loss, its
    metrics and LtState in f32. Then the U-Net's gradients in train mode,
    leaf by leaf, under the loss's cotangent of its output, in float64 on
    both sides: in f32 the image's entries (-69 and 0) and the BatchNorms,
    which cancel the gradient of their input's large mean, leave each side's
    gradients up to 5e-3 of a leaf's largest entry from the other's."""
    cfg = _vqo_config(tiny_config)
    tcfg = t_config_from_dict(cfg.to_dict())
    jc, tc = j_comp_mod.VQDiffusionComposite(cfg), t_comp_mod.VQDiffusionComposite(tcfg)
    k, n = jc.codebook_size, jc.seq_len
    variables = numpy_variables(jc.unet, 8, jnp.zeros((1, k, n, 1)), None,
                                jnp.zeros((1,), jnp.int32))
    x = np.random.RandomState(9).uniform(-1, 1, (3, 32, 32, 3)).astype(np.float32)
    vq = jc.vqvae.init(jax.random.PRNGKey(0), jnp.asarray(x[:1]))["params"]
    tc.vqvae.load_state_dict(W.vqvae_state_from_jax(jax.device_get(vq), tcfg), strict=True)
    state = _unet_state(variables["params"], variables["batch_stats"])
    tc.unet.load_state_dict(state, strict=True)
    rs = np.random.RandomState(10)
    lt = random_lt(rs, jc.timesteps, warm=False)
    rng = jax.random.PRNGKey(11)
    want, want_metrics, _, want_lt = jax.jit(jc.loss)(
        variables["params"], vq, variables["batch_stats"], lt_to_jax(lt), jnp.asarray(x), rng)
    t, gumbel = jax_draws(jc.prior, rng, 3, lt_to_jax(lt))
    seen = {}

    def keep(module, args, out):
        out.retain_grad()
        seen.update(x=args[0].detach(), t=args[2], out=out)
    hook = tc.unet.register_forward_hook(keep)
    got, got_metrics, got_lt = tc.loss(_t(x), t=t, noise=gumbel, lt=lt)
    hook.remove()
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=UNET_RTOL)
    for name in want_metrics:
        np.testing.assert_allclose(float(got_metrics[name]), float(want_metrics[name]),
                                   rtol=UNET_RTOL, err_msg=name)
    assert_lt_close(got_lt, want_lt, rtol=HISTORY_RTOL)

    x_in, t_in, cot = seen["x"], seen["t"], seen["out"].grad
    assert tuple(x_in.shape) == (3, k, n, 1) and float(x_in.min()) < -69
    port64 = TorchUNet(jc.timesteps, 256, 1, 1, 16, (1,)).double()
    port64.load_state_dict(state, strict=True)
    (port64.train()(x_in.double(), None, t_in) * cot.double()).sum().backward()
    with jax.enable_x64(True):
        unet64 = JaxUNet(jc.timesteps, 256, 1, 1, 16, (1,), dtype=jnp.float64)
        as64 = functools.partial(jax.tree_util.tree_map, lambda v: jnp.asarray(v, jnp.float64))

        @jax.jit
        def grad64(params, stats, x_in, t_in, cot):
            def f(p):
                out, _ = unet64.apply({"params": p, "batch_stats": stats}, x_in, None, t_in,
                                      train=True, mutable=["batch_stats"])
                return jnp.sum(out * cot)
            return jax.grad(f)(params)
        grads = jax.device_get(grad64(as64(variables["params"]), as64(variables["batch_stats"]),
                                      as64(x_in.numpy()), jnp.asarray(t_in.numpy()),
                                      as64(cot.numpy())))
    want_grads = _unet_state(grads, variables["batch_stats"])
    _grads_close({k: p.grad for k, p in port64.named_parameters()},
                 {k: v for k, v in want_grads.items()
                  if "running" not in k and "num_batches" not in k})


def port_worker(jax_worker, cfg, state) -> TorchWorker:
    """A port worker on the CPU carrying the JAX worker's VQVAE, U-Net, EMA
    copy and history, with a fresh optimizer."""
    tc = t_config_from_dict(cfg.to_dict())
    tw = TorchWorker(tc, tempfile.mkdtemp(), device="cpu", num_iters_per_epoch=ITERS)
    ts = tw.init_state()
    state = jax.device_get(state)
    tw.composite.vqvae.load_state_dict(W.vqvae_state_from_jax(state.vq_params, tc), strict=True)
    ts.unet.load_state_dict(_unet_state(state.unet_params, state.unet_batch_stats), strict=True)
    ts.ema.load_state_dict(_unet_state(state.ema_params, state.ema_batch_stats), strict=True)
    ts.lt = lt_to_torch(state.lt_state)
    return tw


@pytest.fixture(scope="module")
def runs(tiny_config, small_unets):
    """Both VQ_Official workers through three steps (JAX keys 0, 1, 2)."""
    cfg = _vqo_config(tiny_config)
    jw = JaxWorker(cfg, tempfile.mkdtemp(), num_iters_per_epoch=ITERS)
    js = jw.init_state()
    tw = port_worker(jw, cfg, js)
    ts = tw.state
    rs = np.random.RandomState(0)
    out = {"jax": [], "port": [], "grads": []}
    for i in range(STEPS):
        b, key = rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32), jax.random.PRNGKey(i)
        t, gumbel = jax_draws(jw.composite.prior, key, BATCH, js.lt_state)
        js, jm = jw.train_step(js, jnp.asarray(b), key)
        host = jax.device_get(js)
        out["jax"].append(({k: float(v) for k, v in jm.items()},
                           _unet_state(host.unet_params, host.unet_batch_stats),
                           _unet_state(host.ema_params, host.ema_batch_stats), host.lt_state))
        ts, tm = tw.train_step(ts, torch.from_numpy(b), t=t, noise=gumbel)
        out["grads"].append({k: p.grad.clone() for k, p in ts.unet.named_parameters()})
        out["port"].append(({k: float(v) for k, v in tm.items()},
                            {k: v.clone() for k, v in ts.unet.state_dict().items()},
                            {k: v.clone() for k, v in ts.ema.state_dict().items()}, ts.lt))
    out["lr"] = max(tw.lr_fn(i) for i in range(STEPS))
    out["port_worker"] = tw
    return out


def assert_params_explained(got: dict, want: dict, steps: int, grads: list, lr: float) -> None:
    """Every parameter within 2 lr a step of JAX's. Where one lies more than
    lr / 10 away in a live leaf (a first-step gradient above ROUNDING of
    the largest), the port's f32 gradient of that entry was, at one of the
    steps so far, within GRAD_F32 of its leaf's largest entry from zero:
    Adam moves such an entry by about lr with the sign each side's f32
    rounding gives it (tests/test_torch_port_vqd_train.py's "99% of each
    live leaf within lr / 10" counts them instead, and fails a 72-entry
    leaf with one). Running statistics by that file's rule with STATS_RTOL."""
    top = max(float(g.abs().max()) for g in grads[0].values())
    for k, g0 in grads[0].items():
        d = (got[k].double() - want[k].double()).abs()
        assert float(d.max()) <= 2 * lr * steps + 1e-6, k
        if float(g0.abs().max()) <= ROUNDING * top:
            continue                      # a gradient of rounding alone, as the file's rule
        small = torch.zeros_like(d, dtype=torch.bool)
        for g in grads[:steps]:
            small |= g[k].abs() <= GRAD_F32 * g[k].abs().max()
        unexplained = int(((d > lr / 10) & ~small).sum())
        assert unexplained == 0, f"{k}: {unexplained} entries more than lr / 10 apart"
    assert_params_close(got, want, steps, set(), lr, stats_rtol=STATS_RTOL)


def test_vqofficial_trajectory_matches_jax(runs):
    """Three steps: the metrics, LtState, U-Net and EMA (parameters and
    statistics; the EMA moves at steps 0 and 2)."""
    for i in range(STEPS):
        (jm, ju, je, jl), (tm, tu, te, tl) = runs["jax"][i], runs["port"][i]
        assert set(tm) == set(jm) == {"vb_loss", "kl", "decoder_nll", "loss"}
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=UNET_RTOL, err_msg=f"step {i} {k}")
        assert_lt_close(tl, jl, f"step {i}", rtol=HISTORY_RTOL)
        assert float(tl.Lt_count.sum()) == BATCH * (i + 1)
        assert_params_explained(tu, ju, i + 1, runs["grads"], runs["lr"])
        assert_params_explained(te, je, i + 1, runs["grads"], runs["lr"])
    assert runs["port_worker"].state.updates == STEPS


# -- the CLIs on the CPU -----------------------------------------------------------------------

def _rows(run_dir):
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_debug_resume_and_generate(tmp_path, tiny_config):
    """--debug on the CPU: two steps with VQ_Official's metrics, a checkpoint
    with its history, the recon grid and the EMA's samples. Resuming goes
    on at step 3 with the history's counts; ``generate --ckpt`` on the
    checkpoint samples the EMA U-Net."""
    data = _vqofficial(tiny_config, tmp_path / "zlog")
    config = tmp_path / "vqo.yml"
    config.write_text(yaml.safe_dump(data))
    first = cli.run(["--config", str(config), "--debug", "--device", "cpu"])
    rows = _rows(first["run_dir"])
    assert [r["step"] for r in rows] == [1, 2, 2]
    assert all({"vb_loss", "kl", "decoder_nll", "loss"} <= set(r) for r in rows[:2])
    for name in ("recon_epoch0_0.jpg", "samples_epoch0.jpg"):
        assert os.path.exists(os.path.join(first["run_dir"], name)), name
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    tree = torch.load(ckpt, weights_only=True)
    assert float(tree["state"]["lt"]["Lt_count"].sum()) == 4      # 2 steps at batch 2
    second = cli.run(["--config", str(config), "--debug", "--device", "cpu"],
                     overrides={"architecture.vqdiffusion.resume_path": ckpt})
    assert second["worker"].global_step == 4
    assert float(second["worker"].state.lt.Lt_count.sum()) == 8
    out = generate.run(["--config", str(config), "--device", "cpu", "--ckpt", ckpt,
                        "--n-samples", "2", "--seed", "3"])
    want = TorchWorker(t_config_from_dict(data), str(tmp_path), seed=3, device="cpu")
    want.init_state()
    want.load(ckpt)
    indices = want.composite.sample(2, generator=torch.Generator().manual_seed(3),
                                    unet=want.state.ema)
    assert torch.equal(out["indices"], indices)


def test_demo_on_cpu(capsys):
    """The demo trains and samples under each posterior route: finite
    losses, the samples in the codebook."""
    assert vq_diffusion.main(["--steps", "4", "--device", "cpu"]) == 0
    assert "fast samples: (4, 8, 8)" in capsys.readouterr().out
    for mode in ("on", "prng"):
        out = vq_diffusion.run(["--steps", "4", "--device", "cpu", "--fused-posterior", mode])
        assert len(out["losses"]) == 4 and all(np.isfinite(out["losses"]))
        for idx in (out["samples"], out["fast"]):
            assert tuple(idx.shape) == (4, 8, 8) and 0 <= int(idx.min()) and int(idx.max()) < 64


def test_demo_refuses_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        vq_diffusion.main(["--steps", "1"])


def test_vqofficial_training_config_is_the_vqdiffusion_config_with_its_changes():
    """VQ_Official with the kernel routes on, and the synthetic batch cut to
    11 (the largest under 70 GiB on the H100, chip_smoke.py (s))."""
    def load(path):
        with open(path) as f:
            return yaml.safe_load(f)
    got, base = load("configs/training_config_vqofficial.yml"), load(
        "configs/training_config_vqdiffusion.yml")
    base["architecture"]["vqdiffusion"].update({"diffusion_type": "VQ_Official",
                                                "fused_posterior": True,
                                                "fused_sampler": "packed"})
    base["dataset"]["batch_size"]["vqdiffusion"]["synthetic"] = 11
    assert got == base

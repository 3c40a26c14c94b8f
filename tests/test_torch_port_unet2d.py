"""The port's Conv2d U-Nets (``models/unet2d.py``: ``Unet2DPixel``,
``SimpleUNet``), their weight maps and the pixel-DDPM CLI
(``vq_vae_gan_diffusion_torch.train_diffusion``) against the JAX package's
modules and the root ``train_diffusion.py``.

Geometry: ``Unet2DPixel`` at dim 16, mults (1, 2) on 16² x 3, batch 2, in
six variants (plain, self-conditioned, learned variance, learned
sinusoids, random Fourier features, full attention in the outer stage and
linear in the inner, against the default's); ``SimpleUNet`` at features
(8, 16). The root CLI's step is a closure inside its ``main``; the tests
rebuild it from the same parts (the flax U-Net with dropout 0, the linear
schedule, ``diffusion_loss``, ``optax.adam``, ``ema_update`` after every
step) and draw its t and noise as it does, from the step's key, then give
them to the port. The JAX params are transplanted, never redrawn.

Tolerances: the U-Nets within 1e-5 (absolute and relative: f32 sum order
over convolutions and attention); ``space_to_depth`` equal; one step's
loss within 1e-5 relative; a 3-step trajectory by the stage-1 rule
(ROADMAP.md §C): the loss within 1e-4 relative at each step, parameters
and the EMA's within 2 lr a step and at least 99% of each live leaf within
lr / 10; 8 DDIM steps with the JAX noise within 1e-4 of the samples'
largest magnitude: a random U-Net's chain over T = 1000 grows x_T to
about 4e4 (the first step, at t = 999, takes x0 as sqrt(1 / ᾱ) x_T -
sqrt(1 / ᾱ - 1) ε̂ with sqrt(1 / ᾱ) about 156), and the two sides agree to
about 6e-7 of it.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vq_vae_gan_diffusion_torch import train_diffusion as tdiff
from vq_vae_gan_diffusion_torch.models import unet2d as tu
from vq_vae_gan_diffusion_torch.weights import simple_unet_state_from_jax, unet2d_state_from_jax
from vq_vae_gan_diffusion_tpu.diffusion import gaussian as jg
from vq_vae_gan_diffusion_tpu.models import unet2d as ju
from vq_vae_gan_diffusion_tpu.utils import ema_update as j_ema_update

UNET = dict(dim=16, dim_mults=(1, 2), channels=3)
VARIANTS = {
    "plain": {},
    "self_condition": {"self_condition": True},
    "learned_variance": {"learned_variance": True},
    "learned_sinusoid": {"learned_sinusoidal_cond": True},
    "random_fourier": {"random_fourier_features": True},
    "full_attn": {"full_attn": (True, False)},
}
T, LR, DECAY, STEPS, B = 1000, 2e-4, 0.999, 3, 2
ROUNDING = 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _nchw(x) -> torch.Tensor:
    return _t(x).permute(0, 3, 1, 2)


def jax_unet(seed: int = 1, **kw):
    """A flax Unet2DPixel, its params as numpy, an input [2, 16, 16, 3] and t."""
    unet = ju.Unet2DPixel(**UNET, **kw)
    x = np.random.RandomState(0).standard_normal((B, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 870], np.int32)
    params = jax.device_get(unet.init(jax.random.PRNGKey(seed), jnp.asarray(x), None,
                                      jnp.asarray(t))["params"])
    return unet, params, x, t


def port_unet(params, **kw) -> tu.Unet2DPixel:
    unet = tu.Unet2DPixel(**UNET, **kw)
    unet.load_state_dict(unet2d_state_from_jax(params), strict=True)
    return unet.eval()


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_unet2d_matches_flax(variant):
    """The same params and input: flax on NHWC, the port on NCHW, with a
    self-conditioning input where the variant takes one (zeros and None
    the same)."""
    kw = VARIANTS[variant]
    unet, params, x, t = jax_unet(**kw)
    cond = np.random.RandomState(2).standard_normal(x.shape).astype(np.float32) \
        if kw.get("self_condition") else None
    want = np.asarray(jax.jit(lambda p, x, c, t: unet.apply({"params": p}, x, c, t))(
        params, x, cond, t))
    port = port_unet(params, **kw)
    with torch.no_grad():
        got = port(_nchw(x), None if cond is None else _nchw(cond), _t(t).long())
    assert tuple(got.shape) == (B, 6 if kw.get("learned_variance") else 3, 16, 16)
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)
    if kw.get("self_condition"):
        with torch.no_grad():
            zeros = port(_nchw(x), torch.zeros_like(_nchw(x)), _t(t).long())
            none = port(_nchw(x), None, _t(t).long())
        assert torch.equal(zeros, none)


@pytest.mark.parametrize("variant", ["plain", "learned_sinusoid", "full_attn"])
def test_unet2d_state_covers_the_port(variant):
    """unet2d_state_from_jax gives exactly the port's keys and shapes (full
    attention where ``full_attn`` asks, linear attention elsewhere, with its
    output RMSNorm); every JAX leaf lands in one entry."""
    kw = VARIANTS[variant]
    _, params, _, _ = jax_unet(**kw)
    got = unet2d_state_from_jax(params)
    port = tu.Unet2DPixel(**UNET, **kw).state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in port.items()}
    assert len(got) == len(jax.tree_util.tree_leaves(params))
    assert ("downs.0.2.to_out.weight" in got) == (variant == "full_attn")
    assert "downs.0.3.conv.weight" in got and "downs.1.3.weight" in got
    assert "ups.0.3.1.weight" in got and "ups.1.3.weight" in got


def test_space_to_depth_matches_jax():
    """2x2 patches to channels in (c, p1, p2) order, as the JAX function
    packs them channels-last."""
    x = np.arange(2 * 6 * 4 * 3, dtype=np.float32).reshape(2, 6, 4, 3)
    want = np.asarray(ju.space_to_depth(jnp.asarray(x)))
    got = tu.space_to_depth(_nchw(x)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_simple_unet_matches_flax():
    """SimpleUNet with the flax ConvTranspose's kernel flipped into torch's
    transposed convolution: within 1e-5."""
    unet = ju.SimpleUNet(features=(8, 16))
    x = np.random.RandomState(3).standard_normal((B, 16, 16, 3)).astype(np.float32)
    t = np.array([5, 700], np.int32)
    params = jax.device_get(unet.init(jax.random.PRNGKey(2), jnp.asarray(x), None,
                                      jnp.asarray(t))["params"])
    want = np.asarray(jax.jit(lambda p, x, t: unet.apply({"params": p}, x, None, t))(
        params, x, t))
    port = tu.SimpleUNet(features=(8, 16))
    state = simple_unet_state_from_jax(params)
    assert len(state) == len(jax.tree_util.tree_leaves(params))
    port.load_state_dict(state, strict=True)
    with torch.no_grad():
        got = port(_nchw(x), None, _t(t).long())
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("net", ["unet2d", "simple"])
def test_init_weights_is_flax_style(net):
    """init_weights: zero biases, unit gains, memory keys and values N(0, 1),
    every kernel within two lecun-normal deviations of its fan-in (the
    transposed convs' fan-in their input channels times the window); the
    same seed draws the same weights."""
    def make():
        m = tu.Unet2DPixel(**UNET) if net == "unet2d" else tu.SimpleUNet(features=(8, 16))
        m.init_weights(torch.Generator().manual_seed(3))
        return m
    a, b = make(), make()
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
        if name.endswith(".bias"):
            assert not p.any(), name
        elif name.endswith(".g"):
            assert torch.equal(p, torch.ones_like(p)), name
        elif name.endswith("mem_kv"):
            assert 0.8 < float(p.std()) < 1.2, name
        else:
            fan_in = p.shape[0] * p[0, 0].numel() if name.startswith("ups_t") else p[0].numel()
            std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
            assert float(p.abs().max()) <= 2 * std * (1 + 1e-6), name


# -- the pixel-DDPM CLI's step and sampler ------------------------------------------------

def jax_step(unet, sched, objective: str = "pred_noise"):
    """The root CLI's train step with its t and noise given: Adam at LR, then
    the EMA at DECAY."""
    opt = optax.adam(LR)

    @jax.jit
    def step(params, opt_state, ema, imgs, t, noise):
        def loss_fn(p):
            def model_fn(x, c, tt):
                return unet.apply({"params": p}, x, c, tt, deterministic=False)
            return jg.diffusion_loss(sched, model_fn, imgs, None, t, noise, objective)[0]
        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, j_ema_update(ema, params, DECAY), loss, grads
    return opt, step


def jax_draws(key, shape):
    """The root CLI's t and noise from a step's key."""
    rng_t, rng_n, _ = jax.random.split(key, 3)
    return (jax.random.randint(rng_t, (shape[0],), 0, T),
            jax.random.normal(rng_n, shape))


def port_trainer(params) -> tuple:
    trainer = tdiff.PixelDDPM(3, 16, dim=16, dim_mults=(1, 2), dropout=0.0, timesteps=T,
                              sampling_timesteps=8, lr=LR, ema_decay=DECAY, device="cpu")
    state = trainer.init_state()
    sd = unet2d_state_from_jax(params)
    state.unet.load_state_dict(sd, strict=True)
    state.ema.load_state_dict(sd, strict=True)
    return trainer, state


@pytest.fixture(scope="module")
def trajectory():
    """Both sides through STEPS steps on the same batches, t and noise: each
    step's losses, the port's U-Net and EMA after each step, the leaves
    live at the first step, and the JAX side's final params and EMA by the
    port's names."""
    unet, params, _, _ = jax_unet(seed=5)
    opt, step = jax_step(unet, jg.make_schedule(T))
    jp, jopt, jema = params, opt.init(params), params
    trainer, state = port_trainer(params)
    rs = np.random.RandomState(9)
    rows = []
    for i in range(STEPS):
        imgs = rs.uniform(-1, 1, (B, 16, 16, 3)).astype(np.float32)
        t, noise = jax_draws(jax.random.PRNGKey(20 + i), imgs.shape)
        jp, jopt, jema, jloss, grads = step(jp, jopt, jema, imgs, t, noise)
        state, out = trainer.train_step(state, _t(imgs), t=_t(t).long(), noise=_t(noise))
        rows.append((float(jloss), float(out["loss"]),
                     {k: v.clone() for k, v in state.unet.state_dict().items()},
                     {k: v.clone() for k, v in state.ema.state_dict().items()}))
        if i == 0:
            port_grads = {k: p.grad.clone() for k, p in state.unet.named_parameters()}
            jax_grads = unet2d_state_from_jax(jax.device_get(grads))
    top = max(float(g.abs().max()) for g in jax_grads.values())
    live = {k for k, g in jax_grads.items() if float(g.abs().max()) > ROUNDING * top}
    return {"rows": rows, "live": live, "port_grads": port_grads, "jax_grads": jax_grads,
            "final": unet2d_state_from_jax(jax.device_get(jp)),
            "ema": unet2d_state_from_jax(jax.device_get(jema)), "state": state}


def test_cli_step_matches_jax(trajectory):
    """The first step from the same weights with the JAX t and noise, dropout
    off: the loss within 1e-5 relative, each live leaf's gradient within
    1e-4 of its largest entry (f32 sum order through the U-Net)."""
    jloss, tloss, _, _ = trajectory["rows"][0]
    np.testing.assert_allclose(tloss, jloss, rtol=1e-5)
    for k in trajectory["live"]:
        g, w = trajectory["port_grads"][k].numpy(), trajectory["jax_grads"][k].numpy()
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4 * np.abs(w).max(), err_msg=k)
    assert len(trajectory["live"]) > len(trajectory["jax_grads"]) // 2


def _assert_params_close(got: dict, want: dict, steps: int, live: set) -> None:
    diffs = {k: (got[k].double() - want[k].double()).abs() for k in want}
    worst = max(diffs, key=lambda k: diffs[k].max())
    assert diffs[worst].max() <= 2 * LR * steps + 1e-6, worst
    for k in live:
        near = (diffs[k] <= LR / 10).double().mean()
        assert near >= 0.99, f"{k}: {100 * float(near):.2f}% within lr / 10"


def test_cli_trajectory_matches_jax(trajectory):
    """Three Adam steps with the EMA moved after each: the loss within 1e-4
    relative at every step; the U-Net's and the EMA's parameters by the
    stage-1 rule; every U-Net leaf moved, and the EMA by 1 - 0.999^3 of
    the U-Net's move."""
    rows = trajectory["rows"]
    for i, (jloss, tloss, _, _) in enumerate(rows):
        np.testing.assert_allclose(tloss, jloss, rtol=1e-4, err_msg=f"step {i}")
    unet, ema = rows[-1][2], rows[-1][3]
    _assert_params_close(unet, trajectory["final"], STEPS, trajectory["live"])
    _assert_params_close(ema, trajectory["ema"], STEPS, trajectory["live"])
    start = unet2d_state_from_jax(jax_unet(seed=5)[1])
    assert all(not torch.equal(unet[k], start[k]) for k in trajectory["live"])
    k = "final_conv.weight"
    moved = (ema[k] - start[k]).abs().max() / (unet[k] - start[k]).abs().max()
    assert 0.001 < float(moved) < 0.004


@pytest.mark.parametrize("eta", [0.0, 1.0])
def test_ddim_samples_match_jax(eta):
    """The root CLI's sampler: x_T and each step's noise from the same key as
    the JAX sample_fn draws them, 8 DDIM steps of the EMA over T = 1000:
    within 1e-4 of the samples' largest magnitude."""
    unet, params, _, _ = jax_unet(seed=6)
    sched = jg.make_schedule(T)
    key = jax.random.PRNGKey(11)

    def sample_fn(p, key):
        x_t = jax.random.normal(key, (B, 16, 16, 3))
        return jg.ddim_sample(sched, lambda x, c, tt: unet.apply({"params": p}, x, c, tt), key,
                              x_t, eta=eta, sampling_timesteps=8)
    want = np.asarray(jax.jit(sample_fn)(params, key))
    x_t = _t(jax.random.normal(key, (B, 16, 16, 3)))
    noise, rng = [], key
    for _ in range(8):
        rng, sub = jax.random.split(rng)
        noise.append(_t(jax.random.normal(sub, (B, 16, 16, 3))))
    trainer, state = port_trainer(params)
    trainer.eta = eta
    got = trainer.sample(state, B, x_t=x_t, step_noise=noise)
    assert tuple(got.shape) == (B, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_train_diffusion_cli_debug(tmp_path):
    """--debug on the CPU: cifar10 falls back to 64 synthetic images, one
    epoch of 11 steps at batch 2 with dropout 0.1, metrics.jsonl, a
    checkpoint with the U-Net, Adam, the EMA and the epoch, and 4 samples
    through 8 DDIM steps as samples_epoch_0.png; the same seed gives the
    same run."""
    argv = ["--debug", "--device", "cpu", "--dim", "8", "--img-size", "16",
            "--data-root", str(tmp_path / "none")]
    out = tdiff.run(argv + ["--log-dir", str(tmp_path / "a")])
    state, save_dir = out["state"], out["save_dir"]
    assert state.step == 11 and len(out["losses"]) == 1 and np.isfinite(out["losses"][0])
    assert state.unet.init_conv.weight.shape == (8, 3, 7, 7)
    assert out["trainer"].dropout == 0.1 and out["trainer"].sampling_timesteps == 8
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert rows[0]["step"] == 11 and rows[0]["loss"] == pytest.approx(out["losses"][0])
    tree = torch.load(os.path.join(save_dir, "ckpt", "step_00000011.pth"), weights_only=True)
    assert {"params", "opt_state", "ema", "epoch", "step"} <= set(tree) and tree["epoch"] == 0
    assert all(torch.equal(tree["ema"][k], v) for k, v in state.ema.state_dict().items())
    assert os.path.exists(os.path.join(save_dir, "samples_epoch_0.png"))
    assert tuple(out["samples"].shape) == (4, 16, 16, 3)
    again = tdiff.run(argv + ["--log-dir", str(tmp_path / "b")])
    assert again["losses"] == out["losses"] and torch.equal(again["samples"], out["samples"])

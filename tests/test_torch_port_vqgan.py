"""The port's stage-1 training step against the JAX package's
``VQGANVQVAEWorker.train_step``, in ``vqgan`` and ``vqvae`` mode, and the
codebook's gradients against ``jax.grad``.

The JAX worker draws its weights (tests/conftest.py::tiny_config, 32x32x3,
batch 4, ``disc_start`` 1); the port takes them transplanted, the LPIPS
weights too, and both run the same three numpy batches. The first step runs
before ``disc_start`` (disc_factor 0), the next two after it.

Tolerances:

- every metric within 1e-4 relative, at each of the three steps; the
  codebook indices of each step identical;
- the step's gradients, before disc_start and at it from the same weights:
  each leaf's within GRAD_TOL (1e-4) of its largest JAX entry (they agree
  to about 2e-5), so a gradient of the wrong size fails where Adam's first
  step (about lr * sign(g)) would hide it; a leaf whose JAX gradient is
  below ROUNDING (1e-5) of the step's largest is rounding (the live leaves
  lie above 9e-5 of it, the rounding ones below 2e-7) and is held to
  GRAD_TOL of the step's largest entry;
- parameters after the steps: every entry within 2 * lr * steps, and in
  each leaf whose gradient is not rounding at least 99% of the entries
  within lr / 10. Adam moves each entry by about lr a step whatever its
  gradient's size, so where a gradient is zero but for f32 rounding (conv
  biases ahead of a one-channel-a-group GroupNorm, attention key biases)
  each side takes its own sign; and the step's gradients agree with a
  float64 evaluation only to about 3e-4 of their largest entry, on either
  side, which Adam's normalisation magnifies where a gradient is small;
- the discriminator's running statistics within 1e-4;
- codebook gradients within 1e-5.
"""

import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.models.codebook import quantize as t_quantize
from vq_vae_gan_diffusion_torch.models.discriminator import Discriminator as TorchDisc
from vq_vae_gan_diffusion_torch.models.vqvae import VQVAE as TorchVQVAE
from vq_vae_gan_diffusion_torch.train.vqgan_worker import VQGANVQVAEWorker as TorchWorker
from vq_vae_gan_diffusion_tpu.models.codebook import quantize as j_quantize
from vq_vae_gan_diffusion_tpu.models.vqvae import VQVAE as JaxVQVAE
from vq_vae_gan_diffusion_tpu.train.vqgan_worker import VQGANVQVAEWorker as JaxWorker
from vq_vae_gan_diffusion_tpu.train.vqgan_worker import make_train_step

STEPS, BATCH, LR = 3, 4, 2.25e-4
METRICS = ("vq_loss", "gan_loss", "q_loss", "perceptual_rec_loss", "lambda", "disc_factor")
GRAD_TOL, ROUNDING = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def port_worker(jax_worker, cfg, state, **kwargs) -> TorchWorker:
    """A port worker on the CPU whose VQVAE, discriminator and LPIPS carry
    the JAX worker's weights, with fresh optimizers."""
    tc = t_config_from_dict(cfg.to_dict())
    tw = TorchWorker(tc, tempfile.mkdtemp(), device="cpu", **kwargs)
    tw.lpips.load_state_dict(W.lpips_state_from_jax(
        jax.tree_util.tree_map(np.asarray, jax_worker.lpips_params)), strict=True)
    state = jax.device_get(state)
    vqvae = TorchVQVAE.from_config(tc)
    vqvae.load_state_dict(W.vqvae_state_from_jax(state.vqvae_params, tc), strict=True)
    disc = None
    if tw.is_gan:
        disc = TorchDisc(3)
        disc.load_state_dict(W.discriminator_state_from_jax(state.disc_params,
                                                            state.disc_batch_stats), strict=True)
    tw.state = tw.make_state(vqvae, disc)
    return tw


def jax_gradients(jax_worker, cfg, state, batch) -> dict:
    """The JAX step's gradients at ``state`` on ``batch``, by the port's
    parameter names (``vqvae.*``, ``disc.*``): the worker's own step built
    with optimizers that keep the gradients as their state and move no
    parameter."""
    keep = optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))
    tr, dcfg = cfg.trainer.vqvae, cfg.trainer.descriminator
    step = make_train_step(
        jax_worker.model, jax_worker.disc, jax_worker.lpips, keep, keep,
        disc_factor=float(dcfg.disc_factor), disc_start=int(dcfg.disc_start),
        perceptual_factor=float(tr.perceptual_loss_factor),
        rec_factor=float(tr.rec_loss_factor), use_hand_mask=jax_worker.use_hand_mask,
        mean=jax_worker.mean, std=jax_worker.std,
        remat=bool(cfg.architecture.vqvae.get("remat", False)),
        lambda_mode=str(tr.get("lambda_mode", "grad2")))
    state = state.replace(opt_state_g=keep.init(state.vqvae_params),
                          opt_state_d=keep.init(state.disc_params) if jax_worker.is_gan else ())
    new, _ = step(state, jnp.asarray(batch), jax.random.PRNGKey(0), jax_worker.lpips_params)
    new = jax.device_get(new)
    tc = t_config_from_dict(cfg.to_dict())
    out = {f"vqvae.{k}": v for k, v in W.vqvae_state_from_jax(new.opt_state_g, tc).items()}
    if jax_worker.is_gan:
        out.update({f"disc.{k}": v for k, v in W.discriminator_state_from_jax(
            new.opt_state_d, new.disc_batch_stats).items()
            if "running" not in k and "num_batches" not in k})
    return out


def port_gradients(state) -> dict:
    """The gradients the port's last step left on its parameters, by name."""
    out = {f"vqvae.{k}": p.grad.clone() for k, p in state.vqvae.named_parameters()}
    if state.disc is not None:
        out.update({f"disc.{k}": p.grad.clone() for k, p in state.disc.named_parameters()})
    return out


def live_leaves(grads: dict) -> set:
    """The leaves whose largest gradient entry is above ROUNDING of the
    step's largest: the rest are zero but for f32 rounding."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {k for k, g in grads.items() if float(g.abs().max()) > ROUNDING * top}


def assert_gradients_close(got: dict, want: dict) -> None:
    """Each leaf within GRAD_TOL of its own largest entry where it is live,
    of the step's largest where it is rounding."""
    assert set(got) == set(want)
    live = live_leaves(want)
    top = max(float(g.abs().max()) for g in want.values())
    for k, g in want.items():
        scale = float(g.abs().max()) if k in live else top
        err = float((got[k].double() - g.double()).abs().max())
        assert err <= GRAD_TOL * scale, f"{k}: {err:.3e} against {scale:.3e}"


def assert_params_close(got: dict, want: dict, steps: int, live: set) -> None:
    """Every entry within 2 lr a step; in each leaf of ``live`` at least
    99% within lr / 10."""
    diffs = {k: (got[k].double() - want[k].double()).abs() for k in want}
    worst = max(diffs, key=lambda k: diffs[k].max())
    assert diffs[worst].max() <= 2 * LR * steps + 1e-6, worst
    for k in live:
        near = (diffs[k] <= LR / 10).double().mean()
        assert near >= 0.99, f"{k}: {100 * float(near):.2f}% within lr / 10"


def running_stats(state) -> dict:
    return W.discriminator_state_from_jax(state.disc_params, state.disc_batch_stats)


@pytest.fixture(scope="module", params=["vqgan", "vqvae"])
def runs(request, tiny_config):
    """Both workers through the same three steps: each step's metrics and
    the indices of its batch, and the states after each step; both steps'
    gradients on the first batch from the starting weights, before
    disc_start and at it, and the leaves whose gradient is not rounding."""
    mode = request.param
    cfg = (tiny_config.replace_path("architecture.model_name", mode)
           .replace_path("trainer.descriminator.disc_start", 1))
    jw = JaxWorker(cfg, tempfile.mkdtemp())
    js = jw.init_state()
    tw = port_worker(jw, cfg, js)
    ts = tw.state
    rs = np.random.RandomState(0)
    batches = [rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32) for _ in range(STEPS)]
    out = {"mode": mode, "cfg": t_config_from_dict(cfg.to_dict()), "jax": [], "port": [],
           "grads": {}}
    at_start = port_worker(jw, cfg, js)
    at_start.state.step = 1
    at_start.train_step(at_start.state, torch.from_numpy(batches[0]))
    out["grads"]["disc_start"] = (port_gradients(at_start.state), jax_gradients(
        jw, cfg, js.replace(step=jnp.ones((), jnp.int32)), batches[0]))
    encode = jax.jit(lambda p, x: jw.model.apply({"params": p}, x, method=JaxVQVAE.encode)[1])
    for i, b in enumerate(batches):
        j_idx = np.asarray(encode(js.vqvae_params, b))
        if i == 0:
            j_grads = jax_gradients(jw, cfg, js, b)
        js, jm = jw.train_step(js, jnp.asarray(b), jax.random.PRNGKey(0))
        out["jax"].append(({k: float(v) for k, v in jm.items()}, j_idx, jax.device_get(js)))
        with torch.no_grad():
            t_idx = ts.vqvae.encode(torch.from_numpy(b))[1].numpy()
        ts, tm = tw.train_step(ts, torch.from_numpy(b))
        if i == 0:
            out["grads"]["step 0"] = (port_gradients(ts), j_grads)
        out["port"].append(({k: float(v) for k, v in tm.items()}, t_idx,
                            {"vqvae": {k: v.clone() for k, v in ts.vqvae.state_dict().items()},
                             "disc": None if ts.disc is None else
                             {k: v.clone() for k, v in ts.disc.state_dict().items()}}))
    out["live"] = live_leaves(out["grads"]["disc_start"][1])
    return out


def live_of(runs, part: str) -> set:
    """The live leaves of ``part`` (vqvae or disc) by their module's names."""
    return {k[len(part) + 1:] for k in runs["live"] if k.startswith(part + ".")}


def _check_step(runs, i: int) -> None:
    (jm, j_idx, js), (tm, t_idx, ts) = runs["jax"][i], runs["port"][i]
    assert set(tm) == set(jm) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-4, atol=1e-7, err_msg=f"step {i} {k}")
    np.testing.assert_array_equal(t_idx, j_idx)
    assert_params_close(ts["vqvae"], W.vqvae_state_from_jax(js.vqvae_params, runs["cfg"]), i + 1,
                        live_of(runs, "vqvae"))
    if runs["mode"] == "vqgan":
        want = running_stats(js)
        for k, v in want.items():
            if "running" in k:
                torch.testing.assert_close(ts["disc"][k], v, rtol=0, atol=1e-4, msg=k)
        assert_params_close({k: v for k, v in ts["disc"].items() if "running" not in k
                             and "num_batches" not in k},
                            {k: v for k, v in want.items() if "running" not in k
                             and "num_batches" not in k}, i + 1, live_of(runs, "disc"))


def test_one_step_matches_jax(runs):
    """The first step: disc_factor 0, yet λ computed in vqgan mode."""
    _check_step(runs, 0)
    jm = runs["jax"][0][0]
    assert jm["disc_factor"] == 0.0 and jm["gan_loss"] == 0.0
    assert (jm["lambda"] > 0) == (runs["mode"] == "vqgan")


@pytest.mark.parametrize("at", ["step 0", "disc_start"])
def test_step_gradients_match_jax(runs, at):
    """The gradients of one step from the same weights and batch, leaf by
    leaf. Before disc_start the discriminator gets none on either side; at
    it, the generator's include λ's GAN term and the discriminator's the
    hinge loss's."""
    got, want = runs["grads"][at]
    assert_gradients_close(got, want)
    disc = [k for k in want if k.startswith("disc.")]
    assert bool(disc) == (runs["mode"] == "vqgan")
    if at == "step 0":
        assert all(float(got[k].abs().max()) == float(want[k].abs().max()) == 0.0
                   for k in disc)
    else:
        assert {k for k in disc if k.endswith("weight")} <= runs["live"]


def test_trajectory_matches_jax(runs):
    """Three steps across disc_start 1: metrics, indices, parameters and
    running statistics after every step."""
    for i in range(STEPS):
        _check_step(runs, i)
    factors = [m["disc_factor"] for m, _, _ in runs["port"]]
    assert factors == ([0.0, 1.0, 1.0] if runs["mode"] == "vqgan" else [0.0] * STEPS)
    if runs["mode"] == "vqgan":
        assert all(m["gan_loss"] > 0 for m, _, _ in runs["port"][1:])


def test_codebook_gradients_match_jax():
    """∂/∂z and ∂/∂codebook of sum(z_q * r) + loss: the straight-through
    estimator passes r to z, the commitment term 2(z - z_q)/N to z and the
    codebook term 2β(z_q - z)/N to the chosen rows."""
    rs = np.random.RandomState(3)
    z = rs.standard_normal((2, 4, 4, 8)).astype(np.float32)
    cb = rs.standard_normal((16, 8)).astype(np.float32)
    r = rs.standard_normal((2, 4, 4, 8)).astype(np.float32)

    def j_loss(z, cb):
        z_q, _, loss = j_quantize(z, cb, 0.25, "exact")
        return jnp.sum(z_q * r) + loss
    gz, gcb = jax.jit(jax.grad(j_loss, argnums=(0, 1)))(jnp.asarray(z), jnp.asarray(cb))
    tz, tcb = torch.from_numpy(z).requires_grad_(), torch.from_numpy(cb).requires_grad_()
    z_q, _, loss = t_quantize(tz, tcb, 0.25, "exact")
    ((z_q * torch.from_numpy(r)).sum() + loss).backward()
    np.testing.assert_allclose(tz.grad.numpy(), np.asarray(gz), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tcb.grad.numpy(), np.asarray(gcb), rtol=1e-5, atol=1e-6)
    assert np.abs(np.asarray(gcb)).sum(1).astype(bool).sum() > 1

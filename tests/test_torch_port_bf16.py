"""``--bf16`` against the JAX package's ``dtype=bfloat16`` (f32 parameters),
at tests/conftest.py::tiny_config.

Both sides run bf16 from the same transplanted weights and the same
injected noise. An f32 run says how far bf16 itself moves each number: at
step level the port's own f32 step (which tests/test_torch_port_{vqgan,
gpt_train,vqd_train,discrete_train}.py hold to the JAX f32 step within
1e-4 relative, a hundredth of what bf16 moves), which saves compiling each
JAX step twice; at forward level flax's f32 forward. **The bf16 rule**
(JAX_f32 below is that f32 run):

- each logged metric: |port - JAX_bf16| <= max(2 |JAX_bf16 - JAX_f32|,
  1e-2 |JAX_f32|);
- each gradient leaf whose norm is above 1e-3 of the largest leaf's: the
  cosine between the port's bf16 gradient and JAX's is at least 0.99; only
  where bf16 itself moves the leaf, that is where JAX's bf16 leaf lies
  farther than 2% of the f32 leaf's norm from it, may the leaf pass instead
  by lying no farther from the f32 gradient than four times JAX's bf16
  gradient does. Over those leaves together the port's bf16 gradients lie
  no farther from f32 than twice JAX's do, and no nearer than a quarter of
  JAX's: an f32 step (autocast never engaged) reads 0 there and fails. The
  escape is needed: at these geometries bf16 alone moves many leaves by
  more than their size (JAX's own bf16 leaves have cosines down to
  0.01-0.7 with its f32 ones at the stage-1 step, the random-VGG LPIPS and
  the GAN term the most), so no second bf16 computation meets 0.99 there,
  and each such leaf's distance is a draw of rounding noise whose size, not
  direction, two implementations share: leaf by leaf the port's draw came
  out up to 3.1 times JAX's, in the sum from 0.59 to 1.19 times;
- after 2 steps every parameter, optimizer moment, EMA leaf and BatchNorm
  statistic is f32, and so is every floating tensor of the checkpoint.

Step level (one step's metrics and gradients): stage 1 (``vqgan``,
``disc_start`` 0 so the GAN terms and λ are live), the GPT prior, the
gaussian3d prior and VQ_Official (its U-Net at base 16, mults (1,), as
tests/test_torch_port_discrete_train.py shrinks it). Forward level (the
metric rule on the output's norm: ||port - JAX_bf16|| <= max(2
||JAX_bf16 - JAX_f32||, 1e-2 ||JAX_f32||), and ||port - JAX_f32|| at least a
quarter of ||JAX_bf16 - JAX_f32||): ``Unet1D``, ``Unet2DPixel``, the VAE,
and the continuous priors' loss.

Controls: the rules fail the port's f32 gradients and forwards (autocast
off), and ``Unet2DPixel`` with its sinusoidal time embedding computed in
bf16 (the f32 cast JAX makes, dropped: t = 870 rounds to 872). Then the codebook's indices under
bf16 autocast against f32, and both CLIs' ``--bf16`` runs resuming from
their f32 checkpoints.
"""

import os
import tempfile
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from test_torch_port_ckpt import _draw
from test_torch_port_discrete_train import jax_draws as discrete_draws
from test_torch_port_discrete_train import lt_to_torch, small_unets  # noqa: F401 (fixture)
from test_torch_port_gpt_train import jax_draws as gpt_draws
from test_torch_port_shuffle import numpy_variables
from test_torch_port_vqd_train import _jax_step_draws, _unet_state
from test_torch_port_vqgan import port_gradients
from test_torch_port_vqgan import port_worker as vqgan_port_worker
from vq_vae_gan_diffusion_torch import train_diffusion as tdiff
from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.models import continuous_vq as tcv
from vq_vae_gan_diffusion_torch.models import unet1d as tu1
from vq_vae_gan_diffusion_torch.models import unet2d as tu2
from vq_vae_gan_diffusion_torch.models.codebook import quantize
from vq_vae_gan_diffusion_torch.models.vae import VAE as TorchVAE
from vq_vae_gan_diffusion_torch.train import cli
from vq_vae_gan_diffusion_torch.train.vq_diffusion_worker import VQDiffusionWorker as TorchVQD
from vq_vae_gan_diffusion_torch.train.vq_transformer_worker import VQTransformerWorker as TorchGPTW
from vq_vae_gan_diffusion_torch.utils import compute_autocast
from vq_vae_gan_diffusion_tpu.diffusion import LtState
from vq_vae_gan_diffusion_tpu.models import continuous_vq as jcv
from vq_vae_gan_diffusion_tpu.models import unet1d as ju1
from vq_vae_gan_diffusion_tpu.models import unet2d as ju2
from vq_vae_gan_diffusion_tpu.models.discriminator import Discriminator as JaxDisc
from vq_vae_gan_diffusion_tpu.models.lpips import LPIPS as JaxLPIPS
from vq_vae_gan_diffusion_tpu.models.vae import VAE as JaxVAE
from vq_vae_gan_diffusion_tpu.models.vq_diffusion_composite import (
    VQDiffusionComposite as JaxComposite)
from vq_vae_gan_diffusion_tpu.models.vq_transformer import VQTransformer as JaxVQT
from vq_vae_gan_diffusion_tpu.models.vqvae import VQVAE as JaxVQVAE
from vq_vae_gan_diffusion_tpu.train.vqgan_worker import VQGANState, make_train_step

BF16, BATCH, ITERS = torch.bfloat16, 4, 5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _batch(seed: int) -> np.ndarray:
    return np.random.RandomState(seed).uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32)


def assert_metrics_rule(port: dict, bf16: dict, f32: dict) -> None:
    assert set(bf16) <= set(port)
    for k, jb in bf16.items():
        jb, jf, p = float(jb), float(f32[k]), float(port[k])
        tol = max(2 * abs(jb - jf), 1e-2 * abs(jf))
        assert abs(p - jb) <= tol, f"{k}: port {p!r}, JAX bf16 {jb!r}, JAX f32 {jf!r}"


def assert_grads_rule(got: dict, want: dict, want32: dict) -> None:
    """The bf16 rule on gradients (module docstring), over the leaves whose
    norm is above 1e-3 of the largest leaf's."""
    assert set(got) == set(want)
    norms = {k: float(torch.linalg.vector_norm(torch.as_tensor(v).double())) for k, v in
             want.items()}
    top = max(norms.values())
    live = [k for k in want if norms[k] > 1e-3 * top]
    port_sq = own_sq = 0.0
    for k in live:
        g, w = got[k].double().flatten(), torch.as_tensor(want[k]).double().flatten()
        w32 = torch.as_tensor(want32[k]).double().flatten()
        cos = float(g @ w / (torch.linalg.vector_norm(g) * torch.linalg.vector_norm(w)))
        port, own = (float(torch.linalg.vector_norm(a - w32)) for a in (g, w))
        moved = own > 0.02 * float(torch.linalg.vector_norm(w32))
        assert cos >= 0.99 or (moved and port <= 4 * own), \
            f"{k}: cosine {cos:.4f}; port {port:.3e} from f32, JAX bf16 {own:.3e}"
        port_sq, own_sq = port_sq + port ** 2, own_sq + own ** 2
    port_all, own_all = port_sq ** 0.5, own_sq ** 0.5
    assert own_all / 4 <= port_all <= 2 * own_all, (port_all, own_all)
    assert len(live) > len(want) / 4


def assert_forward_rule(port, bf16, f32) -> None:
    p, jb, jf = (np.asarray(torch.as_tensor(np.asarray(v, np.float32)).double())
                 if not isinstance(v, torch.Tensor) else v.double().numpy()
                 for v in (port, bf16, f32))
    own = np.linalg.norm(jb - jf)
    assert np.linalg.norm(p - jb) <= max(2 * own, 1e-2 * np.linalg.norm(jf)), \
        (np.linalg.norm(p - jb), own)
    assert np.linalg.norm(p - jf) >= own / 4, (np.linalg.norm(p - jf), own)


def assert_all_f32(*objs) -> None:
    """Every floating tensor of the modules, optimizers and trees is f32."""
    def walk(node, path):
        if isinstance(node, torch.Tensor):
            assert not node.is_floating_point() or node.dtype == torch.float32, \
                f"{path}: {node.dtype}"
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}.{k}")
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{path}[{i}]")
    for i, obj in enumerate(objs):
        walk(obj.state_dict() if hasattr(obj, "state_dict") else obj, f"#{i}")


def _keep():
    """An optax transformation that keeps the gradients as its state and
    moves no parameter."""
    return optax.GradientTransformation(
        lambda p: jax.tree_util.tree_map(jnp.zeros_like, p),
        lambda g, s, p=None: (jax.tree_util.tree_map(jnp.zeros_like, g), g))


# -- stage 1 ---------------------------------------------------------------------------------

def _vqgan_jax(jw, cfg, state, batch):
    """The JAX step's metrics and gradients (by the port's names) at
    ``state`` on ``batch``, with the worker's model dtype."""
    keep = _keep()
    tr, dcfg = cfg.trainer.vqvae, cfg.trainer.descriminator
    step = make_train_step(
        jw.model, jw.disc, jw.lpips, keep, keep, disc_factor=float(dcfg.disc_factor),
        disc_start=int(dcfg.disc_start), perceptual_factor=float(tr.perceptual_loss_factor),
        rec_factor=float(tr.rec_loss_factor), use_hand_mask=False, mean=jw.mean, std=jw.std,
        remat=False, lambda_mode=str(tr.get("lambda_mode", "grad2")))
    state = state.replace(opt_state_g=keep.init(state.vqvae_params),
                          opt_state_d=keep.init(state.disc_params) if jw.is_gan else ())
    new, metrics = step(state, jnp.asarray(batch), jax.random.PRNGKey(0), jw.lpips_params)
    new = jax.device_get(new)
    tc = t_config_from_dict(cfg.to_dict())
    grads = {f"vqvae.{k}": v for k, v in W.vqvae_state_from_jax(new.opt_state_g, tc).items()}
    if jw.is_gan:
        grads.update({f"disc.{k}": v for k, v in W.discriminator_state_from_jax(
            new.opt_state_d, new.disc_batch_stats).items()
            if "running" not in k and "num_batches" not in k})
    return {k: float(v) for k, v in metrics.items()}, grads


def test_vqgan_step_by_the_bf16_rule(tiny_config):
    cfg = (tiny_config.replace_path("architecture.model_name", "vqgan")
           .replace_path("trainer.descriminator.disc_start", 0))
    dummy = jnp.zeros((1, 32, 32, 3))
    disc = numpy_variables(JaxDisc(), 2, dummy)
    js = VQGANState(vqvae_params=_numpy_params(JaxVQVAE.from_config(cfg), dummy, seed=0),
                    disc_params=disc["params"], disc_batch_stats=disc["batch_stats"],
                    opt_state_g=(), opt_state_d=(), step=jnp.zeros((), jnp.int32))
    lpips = _numpy_params(JaxLPIPS(), dummy, dummy, seed=3)
    j16 = SimpleNamespace(model=JaxVQVAE.from_config(cfg, dtype=jnp.bfloat16),
                          disc=JaxDisc(dtype=jnp.bfloat16), lpips=JaxLPIPS(dtype=jnp.bfloat16),
                          lpips_params=lpips, mean=[0.5] * 3, std=[0.5] * 3, is_gan=True)
    b = _batch(0)
    m16, g16 = _vqgan_jax(j16, cfg, js, b)
    assert m16["disc_factor"] == 1.0 and m16["gan_loss"] > 0 and m16["lambda"] > 0
    f32 = vqgan_port_worker(j16, cfg, js)
    _, m32 = f32.train_step(f32.state, torch.from_numpy(b))
    tw = vqgan_port_worker(j16, cfg, js, dtype=BF16)
    ts, tm = tw.train_step(tw.state, torch.from_numpy(b))
    assert_metrics_rule(tm, m16, m32)
    assert_grads_rule(port_gradients(ts), g16, port_gradients(f32.state))
    ts, _ = tw.train_step(ts, torch.from_numpy(_batch(1)))
    assert_all_f32(ts.vqvae, ts.disc, ts.opt_g, ts.opt_d, tw.checkpoint_tree())


# -- the GPT prior ---------------------------------------------------------------------------

def _gpt_jax(composite, state, batch, rng):
    def loss_fn(gpt_params):
        logits, targets = composite.forward(gpt_params, state.vq_params, batch, rng)
        logits = logits.astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(
            logits.reshape(-1, logits.shape[-1]), targets.reshape(-1)).mean()
        return ce, jnp.mean((jnp.argmax(logits, -1) == targets).astype(jnp.float32))
    (ce, acc), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(state.gpt_params)
    return {"ce_loss": float(ce), "token_accuracy": float(acc)}, \
        W.gpt_state_from_jax(jax.device_get(grads))


def test_gpt_step_by_the_bf16_rule(tiny_config):
    cfg = tiny_config.replace_path("architecture.model_name", "vqvae_transformer")
    j16 = SimpleNamespace(composite=JaxVQT(cfg, dtype=jnp.bfloat16))
    c = j16.composite
    js = SimpleNamespace(vq_params=_numpy_params(c.vqvae, jnp.zeros((1, 32, 32, 3)), seed=0),
                         gpt_params=_numpy_params(c.gpt, jnp.zeros((1, c.seq_len), jnp.int32)))
    b, key = _batch(2), jax.random.PRNGKey(3)
    m16, g16 = _gpt_jax(j16.composite, js, jnp.asarray(b), key)
    keep, rand = gpt_draws(j16, b, key)
    tc = t_config_from_dict(cfg.to_dict())
    runs = {}
    for dtype in (torch.float32, BF16):
        tw = TorchGPTW(tc, tempfile.mkdtemp(), device="cpu", dtype=dtype)
        ts = tw.init_state()
        tw.composite.vqvae.load_state_dict(W.vqvae_state_from_jax(js.vq_params, tc), strict=True)
        ts.gpt.load_state_dict(W.gpt_state_from_jax(js.gpt_params), strict=True)
        ts, tm = tw.train_step(ts, torch.from_numpy(b), keep=keep, random_indices=rand)
        runs[dtype] = (tw, tm, {k: p.grad for k, p in ts.gpt.named_parameters()})
    (_, m32, g32), (tw, tm, got) = runs[torch.float32], runs[BF16]
    assert_metrics_rule(tm, m16, m32)
    g16 = {k: v for k, v in g16.items() if "mask" not in k}
    assert_grads_rule(got, g16, g32)
    with pytest.raises(AssertionError):                  # control: autocast off
        assert_grads_rule(g32, g16, g32)
    ts, _ = tw.train_step(tw.state, torch.from_numpy(_batch(4)))
    assert_all_f32(ts.gpt, ts.opt, tw.checkpoint_tree())


# -- the diffusion priors --------------------------------------------------------------------

def _vqd_config(tiny_config, diffusion_type: str):
    cfg = (tiny_config.replace_path("architecture.model_name", "vqdiffusion")
           .replace_path("architecture.vqdiffusion.diffusion_type", diffusion_type))
    if diffusion_type == "gaussiandiffusion3d":
        cfg = (cfg.replace_path("architecture.vqdiffusion.unet_base_dim", 16)
               .replace_path("architecture.vqdiffusion.unet_dim_mults", [1, 2]))
    return cfg


def _vqd_state(c):
    """The JAX worker's state fields that the step reads, for composite
    ``c``: the VQVAE and the U-Net drawn with numpy on ``jax.eval_shape``'s
    shapes (no init to run), fresh BatchNorm statistics, the EMA a copy and
    a fresh LtState, as ``VQDiffusionWorker.init_state`` starts them."""
    vq_params = _numpy_params(c.vqvae, jnp.zeros((1, 32, 32, 3)), seed=0)
    k, n, d = c.codebook_size, c.seq_len, c.gaussian_dim
    dummy = jnp.zeros((1, k, n, 1) if c.diffusion_type == "VQ_Official" else (1, n, d, 1))
    shapes = jax.eval_shape(lambda: c.unet.init(jax.random.PRNGKey(0), dummy, None,
                                                jnp.zeros((1,), jnp.int32), train=False))
    params = _draw(shapes["params"], 1)
    stats = jax.tree_util.tree_map_with_path(
        lambda path, leaf: np.full(leaf.shape, path[-1].key == "var", np.float32),
        shapes["batch_stats"])
    return SimpleNamespace(vq_params=vq_params, unet_params=params, unet_batch_stats=stats,
                           ema_params=params, ema_batch_stats=stats,
                           lt_state=(LtState.init(c.timesteps)
                                     if c.diffusion_type == "VQ_Official" else ()))


def _vqd_jax(c, state, batch, rng):
    def loss_fn(p):
        lt = state.lt_state if c.diffusion_type == "VQ_Official" else None
        loss, metrics, _, _ = c.loss(p, state.vq_params, state.unet_batch_stats, lt, batch, rng)
        return loss, metrics
    (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        state.unet_params)
    metrics = {k: float(v) for k, v in dict(metrics, loss=loss).items()}
    return metrics, _unet_state(grads, state.unet_batch_stats)


def _vqd_port(cfg, js, dtype):
    tc = t_config_from_dict(cfg.to_dict())
    tw = TorchVQD(tc, tempfile.mkdtemp(), device="cpu", num_iters_per_epoch=ITERS, dtype=dtype)
    ts = tw.init_state()
    tw.composite.vqvae.load_state_dict(W.vqvae_state_from_jax(js.vq_params, tc), strict=True)
    ts.unet.load_state_dict(_unet_state(js.unet_params, js.unet_batch_stats), strict=True)
    ts.ema.load_state_dict(_unet_state(js.ema_params, js.ema_batch_stats), strict=True)
    if ts.lt is not None:
        ts.lt = lt_to_torch(js.lt_state)
    return tw


@pytest.mark.parametrize("diffusion_type", ["gaussiandiffusion3d", "VQ_Official"])
def test_diffusion_step_by_the_bf16_rule(tiny_config, small_unets, diffusion_type):
    cfg = _vqd_config(tiny_config, diffusion_type)
    js = _vqd_state(JaxComposite(cfg))
    c = JaxComposite(cfg, dtype=jnp.bfloat16)
    j16 = SimpleNamespace(composite=c)
    b, key = _batch(5), jax.random.PRNGKey(6)
    if diffusion_type == "VQ_Official":
        t, noise = discrete_draws(j16.composite.prior, key, BATCH, js.lt_state)
    else:
        t, noise = _jax_step_draws(j16, key)
    f32 = _vqd_port(cfg, js, torch.float32)
    # the frozen VQVAE's indices from its f32 forward on every side: in bf16
    # each side's rounding flips its own near-tie argmins, which the prior's
    # losses read position by position (the VQVAE's bf16 forward is the
    # stage-1 and GPT tests')
    idx = f32.composite.encode_to_z(torch.from_numpy(b))
    c.encode_to_z = lambda vq_params, x: jnp.asarray(idx.numpy())
    m16, g16 = _vqd_jax(c, js, jnp.asarray(b), key)
    f32.composite.encode_to_z = lambda x: idx
    _, m32 = f32.train_step(f32.state, torch.from_numpy(b), t=t, noise=noise)
    tw = _vqd_port(cfg, js, BF16)
    tw.composite.encode_to_z = lambda x: idx
    ts, tm = tw.train_step(tw.state, torch.from_numpy(b), t=t, noise=noise)
    assert_metrics_rule(tm, m16, m32)
    assert_grads_rule({k: p.grad for k, p in ts.unet.named_parameters()},
                      {k: v for k, v in g16.items()
                       if "running" not in k and "num_batches" not in k},
                      {k: p.grad for k, p in f32.state.unet.named_parameters()})
    ts, _ = tw.train_step(ts, torch.from_numpy(_batch(7)))
    assert_all_f32(ts.unet, ts.ema, ts.opt, tw.checkpoint_tree())
    assert tw.composite.dtype == BF16


# -- forward level ---------------------------------------------------------------------------

def _numpy_params(module, *args, seed: int = 1):
    """``module``'s params drawn with numpy (tests/test_torch_port_ckpt.py's
    draw) on the shapes ``jax.eval_shape`` gives: no init to compile."""
    return _draw(jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args))["params"],
                 seed)


def _flax_pair(cls, kw, x, t, cond=None):
    """(params, f32 output, bf16 output) of a flax module class."""
    f32, b16 = cls(**kw), cls(**kw, dtype=jnp.bfloat16)
    params = _numpy_params(f32, jnp.asarray(x), cond, jnp.asarray(t))
    outs = [np.asarray(jax.jit(lambda p, m=m: m.apply({"params": p}, x, cond, t))(params),
                       np.float32) for m in (f32, b16)]
    return params, outs[0], outs[1]


def test_unet1d_forward_by_the_bf16_rule():
    kw = dict(dim=8, dim_mults=(1, 2), channels=6)
    x = np.random.RandomState(0).standard_normal((2, 16, 6)).astype(np.float32)
    t = np.array([3, 7], np.int32)
    params, want32, want16 = _flax_pair(ju1.Unet1D, kw, x, t)
    unet = tu1.Unet1D(**kw)
    unet.load_state_dict(W.unet1d_state_from_jax(params), strict=True)
    with torch.no_grad(), compute_autocast("cpu", BF16):
        got = unet.eval()(_t(x).transpose(1, 2), None, _t(t).long())
    assert got.dtype == BF16
    assert_forward_rule(got.float().transpose(1, 2), want16, want32)


def test_unet2d_forward_by_the_bf16_rule():
    kw = dict(dim=16, dim_mults=(1, 2), channels=3)
    x = np.random.RandomState(0).standard_normal((2, 16, 16, 3)).astype(np.float32)
    t = np.array([3, 870], np.int32)
    params, want32, want16 = _flax_pair(ju2.Unet2DPixel, kw, x, t)
    unet = tu2.Unet2DPixel(**kw)
    unet.load_state_dict(W.unet2d_state_from_jax(params), strict=True)

    def forward(dtype):
        with torch.no_grad(), compute_autocast("cpu", dtype):
            got = unet.eval()(_t(x).permute(0, 3, 1, 2), None, _t(t).long())
        return got.float().permute(0, 2, 3, 1)
    assert_forward_rule(forward(BF16), want16, want32)
    with pytest.raises(AssertionError):                  # control: autocast off
        assert_forward_rule(forward(torch.float32), want16, want32)
    f32_args = tu1.SinusoidalPosEmb.forward
    with pytest.MonkeyPatch.context() as mp, pytest.raises(AssertionError):
        # control: the time embedding's f32 island dropped
        mp.setattr(tu1.SinusoidalPosEmb, "forward",
                   lambda self, time, dtype=None: f32_args(self, time, BF16))
        assert_forward_rule(forward(BF16), want16, want32)


def test_vae_forward_by_the_bf16_rule(tiny_config):
    cfg = tiny_config.replace_path("architecture.model_name", "vae")
    m32, m16 = JaxVAE.from_config(cfg), JaxVAE.from_config(cfg, dtype=jnp.bfloat16)
    x = _batch(8)
    params = _numpy_params(m32, jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(1))
    key = jax.random.PRNGKey(7)
    want32, want16 = (jax.jit(lambda p, m=m: m.apply({"params": p}, x, key))(params)
                      for m in (m32, m16))
    eps = _t(jax.random.normal(key, (BATCH, 8, 8, 32), jnp.float32))
    tc = t_config_from_dict(cfg.to_dict())
    vae = TorchVAE.from_config(tc)
    vae.load_state_dict(W.vae_state_from_jax(params, tc), strict=True)
    with torch.no_grad(), compute_autocast("cpu", BF16):
        got = vae.eval()(torch.from_numpy(x), eps=eps)
    for g, w16, w32 in zip(got, want16, want32):
        assert_forward_rule(g.float(), np.asarray(w16, np.float32), np.asarray(w32, np.float32))


@pytest.mark.parametrize("model", ["c_vqdiffusion", "v_vqdiffusion"])
def test_continuous_prior_loss_by_the_bf16_rule(tiny_config, model):
    cfg = tiny_config.replace_path("architecture.model_name", model)
    cfg = (cfg.replace_path("architecture.vqdiffusion.unet_base_dim", 8)
           .replace_path("architecture.vqdiffusion.unet_dim_mults", [1, 2]))
    j_cls, t_cls = ((jcv.V_VQDiffusion, tcv.V_VQDiffusion) if model.startswith("v_")
                    else (jcv.C_VQDiffusion, tcv.C_VQDiffusion))
    j32, j16 = j_cls(cfg), j_cls(cfg, dtype=jnp.bfloat16)
    tcfg = t_config_from_dict(cfg.to_dict())
    tp = t_cls(tcfg)
    params = _numpy_params(j32.unet, jnp.zeros((1, 64, tp.channels)), None,
                           jnp.zeros((1,), jnp.int32))
    vq = _numpy_params(j32.vqvae, jnp.zeros((1, 32, 32, 3)), seed=0)
    tp.vqvae.load_state_dict(W.vqvae_state_from_jax(vq, tcfg), strict=True)
    tp.unet.load_state_dict(W.unet1d_state_from_jax(params), strict=True)
    x = _batch(9)[:3]
    rng = jax.random.PRNGKey(11)
    want32, want16 = (float(jax.jit(m.loss)(params, vq, jnp.asarray(x), rng)) for m in (j32, j16))
    rng_t, rng_n = jax.random.split(rng)
    t = _t(jax.random.randint(rng_t, (3,), 0, 8)).long()
    noise = _t(jax.random.normal(rng_n, (3, tp.channels, 64)))
    with compute_autocast("cpu", BF16):
        got = tp.loss(torch.from_numpy(x), t=t, noise=noise)
    assert got.dtype == torch.float32
    assert_metrics_rule({"loss": float(got)}, {"loss": want16}, {"loss": want32})


# -- the codebook and the CLIs ---------------------------------------------------------------

def test_codebook_indices_stay_f32_under_bf16():
    """The distance matmul runs in f32 under bf16 autocast (JAX casts both
    operands to f32): the indices equal the f32 indices on the same z, and a
    bf16 matmul of the same scores would flip some."""
    rs = np.random.RandomState(12)
    z = torch.from_numpy(rs.standard_normal((8, 16, 16, 32)).astype(np.float32))
    cb = torch.from_numpy(rs.standard_normal((512, 32)).astype(np.float32))
    want = quantize(z, cb)[1]
    with compute_autocast("cpu", BF16):
        got = quantize(z, cb)[1]
        rounded = (-2.0 * (z.reshape(-1, 32) @ cb.T) + (cb ** 2).sum(1)).argmin(1)
    assert torch.equal(got, want)
    assert not torch.equal(rounded.reshape(want.shape), want)


def test_train_cli_bf16_writes_f32_checkpoints_that_resume(tmp_path, tiny_config):
    data = (tiny_config.replace_path("architecture.model_name", "vqgan")
            .replace_path("trainer.log_dir", str(tmp_path / "zlog")).to_dict())
    path = tmp_path / "vqgan.yml"
    path.write_text(yaml.safe_dump(data))
    first = cli.run(["--config", str(path), "--debug", "--device", "cpu", "--bf16"])
    assert first["worker"].dtype == BF16 and np.isfinite(first["metrics"]["vq_loss"])
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    tree = torch.load(ckpt, weights_only=True)
    assert_all_f32(tree)
    second = cli.run(["--config", str(path), "--debug", "--device", "cpu", "--bf16"],
                     overrides={"architecture.vqvae.resume_path": ckpt})
    assert second["worker"].global_step == 4


def test_train_diffusion_bf16_writes_f32_checkpoints_that_resume(tmp_path):
    argv = ["--debug", "--device", "cpu", "--dim", "8", "--img-size", "16", "--bf16",
            "--data-root", str(tmp_path / "none"), "--log-dir", str(tmp_path / "a")]
    out = tdiff.run(argv)
    assert out["trainer"].dtype == BF16 and np.isfinite(out["losses"][0])
    ckpt = os.path.join(out["save_dir"], "ckpt", "step_00000011.pth")
    tree = torch.load(ckpt, weights_only=True)
    assert_all_f32(tree)
    trainer = tdiff.PixelDDPM(3, 16, dim=8, device="cpu", dtype=BF16)
    state = trainer.init_state()
    state.unet.load_state_dict(tree["params"], strict=True)
    state.ema.load_state_dict(tree["ema"], strict=True)
    state.opt.load_state_dict(tree["opt_state"])
    imgs = torch.from_numpy(np.random.RandomState(13).uniform(-1, 1, (2, 16, 16, 3))
                            .astype(np.float32))
    state, metrics = trainer.train_step(state, imgs)
    assert np.isfinite(float(metrics["loss"])) and metrics["loss"].dtype == torch.float32
    assert_all_f32(state.unet, state.ema, state.opt)

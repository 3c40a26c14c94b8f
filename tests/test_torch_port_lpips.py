"""The port's LPIPS against the JAX package's: the value and its gradient
with respect to the second input at 32x32x3 and 28x28x1 (the MNIST path:
grey repeated to RGB, pools flooring 7 -> 3 -> 1), on the JAX package's own
``load_lpips_params()`` (its seeded random VGG) transplanted; the weight
map; the ``.npz`` and ``.pth`` loaders and the search order; the seeded
random fallback.

Each JAX reference runs under one ``jax.jit``. Tolerances: the distance
within 1e-4 relative and its input gradient within 1e-4 of its largest
entry (13 f32 convolutions summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.models import lpips as tl
from vq_vae_gan_diffusion_torch.weights import lpips_state_from_jax
from vq_vae_gan_diffusion_tpu.models import lpips as jl


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_params():
    """The JAX package's fallback weights (PRNGKey(42)), with lin weights of
    both signs so that |lin| counts."""
    p = jax.tree_util.tree_map(np.asarray, jl.load_lpips_params(None))
    rs = np.random.RandomState(0)
    for i in range(5):
        p[f"lin{i}"] = rs.uniform(-1.0, 1.0, p[f"lin{i}"].shape).astype(np.float32)
    return p


def _port(params) -> tl.LPIPS:
    m = tl.LPIPS()
    m.load_state_dict(lpips_state_from_jax(params), strict=True)
    return m.eval()


@pytest.mark.parametrize("shape", [(2, 32, 32, 3), (3, 28, 28, 1)])
def test_value_and_input_gradient_match_jax(jax_params, shape):
    rs = np.random.RandomState(1)
    x = rs.uniform(-1, 1, shape).astype(np.float32)
    d = rs.uniform(-1, 1, shape).astype(np.float32)
    model = jl.LPIPS()

    @jax.jit
    def value_and_grad(p, x, d):
        def f(d):
            out = model.apply({"params": p}, x, d)
            return jnp.mean(out), out
        (_, out), g = jax.value_and_grad(f, has_aux=True)(d)
        return out, g
    want, want_g = value_and_grad(jax_params, x, d)
    tm = _port(jax_params)
    dt = torch.from_numpy(d).requires_grad_(True)
    got = tm(torch.from_numpy(x), dt)
    got.mean().backward()
    assert tuple(got.shape) == (shape[0], 1, 1, 1)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-4, atol=1e-7)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(dt.grad.numpy(), want_g, rtol=0,
                               atol=1e-4 * np.abs(want_g).max())


def test_state_keys_and_identical_inputs(jax_params):
    tm = _port(jax_params)
    assert set(lpips_state_from_jax(jax_params)) == set(tm.state_dict())
    x = torch.from_numpy(np.random.RandomState(2).uniform(-1, 1, (2, 16, 16, 3))
                         .astype(np.float32))
    with torch.no_grad():
        assert float(tm(x, x).abs().max()) < 1e-6


def _npz(params, path):
    """The layout of tools/export_lpips_weights.py."""
    out = {f"vgg/{conv}/{leaf}": v for conv, sub in params["vgg"].items()
           for leaf, v in sub.items()}
    out.update({k: v for k, v in params.items() if k != "vgg"})
    np.savez(path, **out)


def _assert_state(model, want):
    got = model.state_dict()
    assert set(got) == set(want)
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_npz_loader_and_search_order(jax_params, tmp_path, monkeypatch):
    """An explicit path, then $LPIPS_WEIGHTS, then weights/lpips_vgg.npz."""
    want = lpips_state_from_jax(jax_params)
    path = tmp_path / "lpips_vgg.npz"
    _npz(jax_params, path)
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)
    _assert_state(tl.load_lpips(str(path)), want)
    monkeypatch.setenv("LPIPS_WEIGHTS", str(path))
    _assert_state(tl.load_lpips(), want)
    monkeypatch.delenv("LPIPS_WEIGHTS")
    (tmp_path / "weights").mkdir()
    path.rename(tmp_path / "weights" / "lpips_vgg.npz")
    model = tl.load_lpips()
    _assert_state(model, want)
    assert not any(p.requires_grad for p in model.parameters()) and not model.training


def test_pth_loader_matches_jax_conversion(jax_params, tmp_path):
    """A torch VGG16 ``features.{i}`` state dict with lpips lin heads: the
    port's reading equals the JAX package's conversion transplanted."""
    sd, i = {}, 0
    for s, (_, n) in enumerate(tl.VGG16_STAGES):
        for c in range(n):
            sub = jax_params["vgg"][f"conv{s}_{c}"]
            sd[f"features.{i}.weight"] = torch.from_numpy(
                np.ascontiguousarray(np.transpose(sub["kernel"], (3, 2, 0, 1))))
            sd[f"features.{i}.bias"] = torch.from_numpy(np.array(sub["bias"]))
            i += 2
        i += 1
    for s in range(5):
        sd[f"lin{s}.model.1.weight"] = torch.from_numpy(
            np.array(jax_params[f"lin{s}"])).view(1, -1, 1, 1)
    path = tmp_path / "vgg.pth"
    torch.save(sd, path)
    jax_read = jax.tree_util.tree_map(np.asarray, jl._params_from_torch(str(path)))
    _assert_state(tl.load_lpips(str(path)), lpips_state_from_jax(jax_read))


def test_random_fallback_is_seeded(tmp_path, monkeypatch, caplog):
    """Nothing found: a warning, lecun-normal convs from torch.Generator(42),
    zero biases, lin weights of one; the same weights on every call."""
    monkeypatch.delenv("LPIPS_WEIGHTS", raising=False)
    monkeypatch.chdir(tmp_path)
    a = tl.load_lpips(str(tmp_path / "missing.npz"))
    assert "not found" in caplog.text
    b = tl.load_lpips()
    _assert_state(b, a.state_dict())
    w = a.vgg["conv2_1"].weight
    assert abs(w.std().item() - (1 / (256 * 9)) ** 0.5) < 2e-3 and not a.vgg["conv2_1"].bias.any()
    assert all(torch.equal(getattr(a, f"lin{i}"), torch.ones(ch))
               for i, (ch, _) in enumerate(tl.VGG16_STAGES))

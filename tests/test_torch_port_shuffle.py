"""The port's ShuffleNet units (``ops/shuffle.py``) against the JAX package's.

The plain versions ``reference_bottleneck`` / ``reference_downsample`` are
held to the JAX Pallas kernels ``fused_bottleneck_packed`` /
``fused_downsample_packed`` run in interpret mode and to the flax units, on
folded parameters with non-trivial BatchNorm statistics, within 3e-5 (the
bound of tests/test_shuffle_packed.py: f32 sums of the same products in
another order). bf16 is held to the flax f32 unit within that file's bf16
bound (atol 0.06, rtol 0.05). The CUDA kernels themselves are checked
against these plain versions on the card by chip_smoke.py.

Every JAX computation runs under one ``jax.jit``: a single compile costs
less than dispatching each operation of the flax unit or of the interpreted
kernel on its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.models.unet_shuffle import ShuffleUNet as TorchUNet
from vq_vae_gan_diffusion_torch.ops.shuffle import (fold_bottleneck_params,
                                                    fold_downsample_params, fused_bottleneck,
                                                    fused_downsample, reference_bottleneck,
                                                    reference_downsample)
from vq_vae_gan_diffusion_torch.weights import shuffle_unet_state_from_jax
from vq_vae_gan_diffusion_tpu.models.unet_shuffle import (ResidualBottleneck,
                                                          ResidualDownsample, ShuffleUNet)
from vq_vae_gan_diffusion_tpu.ops import shuffle_pallas as jsp


def numpy_variables(mod, seed, *args):
    """Variables for the flax module ``mod`` drawn with numpy: kernels
    N(0, 1/fan_in), BatchNorm scale 1 + N(0, 0.1^2), var U(0.5, 1.5), every
    other leaf N(0, 0.1^2). Non-trivial statistics, so a wrong BatchNorm
    fold shows; ``eval_shape`` spares the XLA compile of ``mod.init``."""
    shapes = jax.eval_shape(lambda: mod.init(jax.random.PRNGKey(0), *args, train=False))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rs.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name == "embedding":
            v = rs.standard_normal(shape) / np.sqrt(shape[-1])
        elif name == "var":
            v = rs.uniform(0.5, 1.5, shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rs.standard_normal(shape)
        else:
            v = 0.1 * rs.standard_normal(shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _to_torch(folded, dtype=torch.float32):
    return {k: torch.from_numpy(np.array(v, np.float32)).reshape(
        np.shape(v)[-1:] if k in ("b1", "c1", "c2", "b2", "c3") else np.shape(v)).to(dtype)
        for k, v in folded.items()}


def _x(shape, seed):
    return np.random.RandomState(seed).standard_normal(shape).astype(np.float32)


def _jit(fn, *args):
    """``fn(*args)`` compiled once, as numpy."""
    return np.asarray(jax.jit(fn)(*args))


def _flax_unit(mod, x, seed):
    variables = numpy_variables(mod, seed, jnp.asarray(x))
    return variables, _jit(lambda v, x: mod.apply(v, x, train=False), variables, x)


def _packed(kernel, xs, folded, g, **kw):
    """The JAX packed kernel in interpret mode on unpacked NHWC inputs
    ``xs``, its output unpacked and concatenated as the shuffled halves."""
    pp = jsp.fold_bottleneck_params_packed(folded, g, dtype=jnp.float32)
    y1, y2 = kernel(*[jsp.pack_images(x, g) for x in xs], pp, interpret=True, **kw)
    return jnp.concatenate([jsp.unpack_images(y1, g), jsp.unpack_images(y2, g)], -1)


@pytest.mark.parametrize("shape,cout", [
    ((4, 16, 12, 16), 16),     # square unit
    ((4, 16, 12, 16), 8),      # rectangular: cout < cin
    ((8, 16, 12, 16), 32),     # rectangular: cout > cin
    ((2, 64, 8, 8), 8),        # tall H: the packed kernel's row tiles
])
def test_reference_bottleneck_matches_jax(shape, cout):
    x = _x(shape, 0)
    variables, flax_out = _flax_unit(ResidualBottleneck(cout), x, 1)
    folded = jsp.fold_bottleneck_params(variables["params"], variables["batch_stats"])
    ch = shape[-1] // 2
    g = jsp.pick_group(shape[0], ch, cout // 2)
    kernel_out = _jit(lambda x, f: _packed(jsp.fused_bottleneck_packed,
                                           (x[..., :ch], x[..., ch:]), f, g), x, folded)
    got = reference_bottleneck(torch.from_numpy(x), _to_torch(folded)).numpy()
    np.testing.assert_allclose(got, kernel_out, atol=3e-5)
    np.testing.assert_allclose(got, flax_out, atol=3e-5)


@pytest.mark.parametrize("shape,cout", [
    ((4, 16, 12, 16), 32),     # C -> 2C at half resolution
    ((2, 32, 8, 8), 16),       # several row tiles
])
def test_reference_downsample_matches_jax(shape, cout):
    x = _x(shape, 2)
    variables, flax_out = _flax_unit(ResidualDownsample(cout), x, 3)
    folded = jsp.fold_downsample_params(variables["params"], variables["batch_stats"])
    g = jsp.pick_group(shape[0], shape[-1], cout // 2)
    kernel_out = _jit(lambda x, f: _packed(jsp.fused_downsample_packed, (x,), f, g), x, folded)
    got = reference_downsample(torch.from_numpy(x), _to_torch(folded)).numpy()
    assert got.shape == flax_out.shape
    np.testing.assert_allclose(got, kernel_out, atol=3e-5)
    np.testing.assert_allclose(got, flax_out, atol=3e-5)


def test_reference_downsample_time_prologue_matches_jax():
    """t_vec: the unit reads silu(x + t_vec) with its zero padding kept."""
    x = _x((4, 16, 12, 16), 4)
    h = 0.3 * _x((4, 16), 5)
    xt = _jit(lambda x, h: jax.nn.silu(x + h[:, None, None, :]), x, h)
    variables, flax_out = _flax_unit(ResidualDownsample(32), xt, 6)
    kernel_out = _jit(lambda x, v, h: jsp.packed_downsample(
        x, v["params"], v["batch_stats"], t_vec=h, interpret=True), x, variables, h)
    folded = jsp.fold_downsample_params(variables["params"], variables["batch_stats"])
    got = reference_downsample(torch.from_numpy(x), _to_torch(folded),
                               torch.from_numpy(h)).numpy()
    np.testing.assert_allclose(got, kernel_out, atol=3e-5)
    np.testing.assert_allclose(got, flax_out, atol=3e-5)


def test_reference_odd_grid_downsample_matches_flax():
    """Odd grids (the JAX package keeps plain ops there) halve to ceil(H/2)."""
    x = _x((2, 7, 5, 8), 7)
    variables, flax_out = _flax_unit(ResidualDownsample(16), x, 8)
    folded = jsp.fold_downsample_params(variables["params"], variables["batch_stats"])
    got = reference_downsample(torch.from_numpy(x), _to_torch(folded)).numpy()
    assert got.shape == flax_out.shape == (2, 4, 3, 16)
    np.testing.assert_allclose(got, flax_out, atol=3e-5)


def test_reference_bottleneck_bf16():
    """bf16 activations and weights, f32 sums: within the JAX package's bf16
    bound of the flax f32 unit, and of the JAX spec run in bf16."""
    x = _x((4, 16, 12, 16), 9)
    variables, flax_out = _flax_unit(ResidualBottleneck(16), x, 10)
    folded = jsp.fold_bottleneck_params(variables["params"], variables["batch_stats"])
    got = reference_bottleneck(torch.from_numpy(x).to(torch.bfloat16),
                               _to_torch(folded, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    np.testing.assert_allclose(got, flax_out, atol=0.06, rtol=0.05)
    spec = _jit(lambda x, f: jsp.reference_bottleneck(
        x.astype(jnp.bfloat16), {k: v.astype(jnp.bfloat16) for k, v in f.items()}
    ).astype(jnp.float32), x, folded)
    np.testing.assert_allclose(got, spec, atol=0.06, rtol=0.05)


@pytest.fixture(scope="module")
def tiny_unets():
    unet = ShuffleUNet(timesteps=10, time_embedding_dim=32, in_channels=1, out_channels=1,
                       base_dim=16, dim_mults=(1, 2))
    x = jnp.asarray(_x((2, 32, 16, 1), 11))
    t = jnp.array([3, 7], jnp.int32)
    variables = numpy_variables(unet, 12, x, None, t)
    port = TorchUNet(10, 32, 1, 1, 16, (1, 2))
    port.load_state_dict(shuffle_unet_state_from_jax(variables["params"],
                                                     variables["batch_stats"]), strict=True)
    return variables, port.eval()


def _close(folded_port, folded_jax):
    want = _to_torch(folded_jax)
    assert set(folded_port) == set(want)
    for k, v in want.items():
        torch.testing.assert_close(folded_port[k], v, rtol=1e-6, atol=1e-6, msg=k)


def test_fold_matches_jax(tiny_unets):
    """Every unit of a U-Net with non-trivial BatchNorm statistics folds to
    the JAX package's folded parameters."""
    variables, port = tiny_unets
    params, stats = variables["params"], variables["batch_stats"]
    for i, blk in enumerate(port.encoder_blocks):
        for k, unit in enumerate(blk.conv0):
            _close(fold_bottleneck_params(unit), jsp.fold_bottleneck_params(
                params[f"enc{i}"][f"bn{k}"], stats[f"enc{i}"][f"bn{k}"]))
        _close(fold_downsample_params(blk.conv1), jsp.fold_downsample_params(
            params[f"enc{i}"]["down"], stats[f"enc{i}"]["down"]))
    for i, unit in enumerate(port.mid_block):
        _close(fold_bottleneck_params(unit),
               jsp.fold_bottleneck_params(params[f"mid{i}"], stats[f"mid{i}"]))
    for i, blk in enumerate(port.decoder_blocks):
        for k, unit in enumerate(blk.conv0):
            _close(fold_bottleneck_params(unit), jsp.fold_bottleneck_params(
                params[f"dec{i}"][f"bn{k}"], stats[f"dec{i}"][f"bn{k}"]))
        _close(fold_bottleneck_params(blk.conv1, torch.float32), jsp.fold_bottleneck_params(
            params[f"dec{i}"]["bn4"], stats[f"dec{i}"]["bn4"]))


def test_wrappers_run_plain_on_cpu_and_count_only_launches():
    rs = np.random.RandomState(13)
    x = torch.from_numpy(rs.standard_normal((2, 6, 4, 8)).astype(np.float32))
    p = {k: torch.from_numpy(rs.standard_normal(s).astype(np.float32)) for k, s in dict(
        k1=(3, 3, 4), b1=(4,), w1=(4, 3), c1=(3,), w2=(4, 4), c2=(4,), k2=(3, 3, 4),
        b2=(4,), w3=(4, 3), c3=(3,)).items()}
    q = {k: torch.from_numpy(rs.standard_normal(s).astype(np.float32)) for k, s in dict(
        k1=(3, 3, 8), b1=(8,), w1=(8, 3), c1=(3,), w2=(8, 3), c2=(3,), k2=(3, 3, 3),
        b2=(3,), w3=(3, 3), c3=(3,)).items()}
    tv = torch.from_numpy(rs.standard_normal((2, 8)).astype(np.float32))
    before = fused_bottleneck.launches, fused_downsample.launches
    out = fused_bottleneck(x, p)
    assert out.shape == (2, 6, 4, 6)
    torch.testing.assert_close(out, reference_bottleneck(x, p), rtol=0, atol=0)
    torch.testing.assert_close(fused_downsample(x, q, tv), reference_downsample(x, q, tv),
                               rtol=0, atol=0)
    assert (fused_bottleneck.launches, fused_downsample.launches) == before
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_bottleneck(x.to("meta"), p)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused_downsample(x.to("meta"), q)

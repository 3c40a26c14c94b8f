"""The port's PatchGAN discriminator against the JAX package's: the weight
map key for key against ``utils/torch_export.export_discriminator``, the
forward on batch statistics (flax's train mode), and the running-statistics
update (flax momentum 0.9, biased batch variance) after
a real call and then a fake one, as the VQGAN step makes them.

Inputs and parameters are drawn with numpy from a seed; each JAX reference
runs under one ``jax.jit``. Tolerances: logits within 1e-4 (the same f32
convolutions summed in other orders, through three BatchNorms); running
statistics within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vq_vae_gan_diffusion_torch.models.discriminator import Discriminator as TorchDisc
from vq_vae_gan_diffusion_torch.weights import discriminator_state_from_jax
from vq_vae_gan_diffusion_tpu.models.discriminator import Discriminator as JaxDisc
from vq_vae_gan_diffusion_tpu.utils.torch_export import export_discriminator

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _variables(shape, seed):
    """JAX parameters and running statistics drawn with numpy: conv kernels,
    biases and BN shifts N(0, 0.1^2), BN scales
    1 + N(0, 0.1^2), running means N(0, 0.1^2), variances U(0.5, 1.5)."""
    init = jax.eval_shape(lambda: JaxDisc().init(jax.random.PRNGKey(0), jnp.zeros(shape),
                                                 train=False))
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            v = 0.1 * rs.standard_normal(leaf.shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rs.standard_normal(leaf.shape)
        elif name == "var":
            v = rs.uniform(0.5, 1.5, leaf.shape)
        else:
            v = 0.1 * rs.standard_normal(leaf.shape)
        return np.asarray(v, np.float32)
    v = jax.tree_util.tree_map_with_path(draw, init)
    return v["params"], v["batch_stats"]


def _pair(shape, seed):
    params, stats = _variables(shape, seed)
    tm = TorchDisc(img_channels=shape[-1])
    tm.load_state_dict(discriminator_state_from_jax(params, stats), strict=True)
    return params, stats, tm


def _stats_np(tm):
    return {f"bn{i}": {"mean": tm.model[b].running_mean.numpy().copy(),
                       "var": tm.model[b].running_var.numpy().copy()}
            for i, b in enumerate((3, 6, 9), start=1)}


def test_state_matches_torch_export():
    params, stats = _variables((1, 28, 28, 1), 0)
    ours = discriminator_state_from_jax(params, stats)
    ref = export_discriminator(params, stats)
    assert sorted(ours) == sorted(ref) == sorted(TorchDisc(1).state_dict())
    for k in ref:
        np.testing.assert_array_equal(ours[k].numpy(), ref[k], err_msg=k)


@pytest.mark.parametrize("shape", [(4, 28, 28, 1), (3, 32, 32, 3)])
def test_train_forward_and_stats_match_jax(shape):
    """A real call then a fake call, each on batch statistics and each
    moving the running statistics (the step's order); then a call that
    leaves them as they are. 28x28 gives [B, 1, 1, 1] logits, 32x32 [B, 2, 2, 1]."""
    params, stats, tm = _pair(shape, 1)
    rs = np.random.RandomState(2)
    real, fake = (rs.standard_normal(shape).astype(np.float32) for _ in range(2))
    jd = JaxDisc()

    @jax.jit
    def jax_calls(params, stats, real, fake):
        out_r, up1 = jd.apply({"params": params, "batch_stats": stats}, real, train=True,
                              mutable=["batch_stats"])
        out_f, up2 = jd.apply({"params": params, "batch_stats": up1["batch_stats"]}, fake,
                              train=True, mutable=["batch_stats"])
        return out_r, out_f, up2["batch_stats"]
    want_r, want_f, want_stats = jax_calls(params, stats, real, fake)
    with torch.no_grad():
        got_r = tm(torch.from_numpy(real), update_stats=True)
        got_f = tm(torch.from_numpy(fake), update_stats=True)
        moved = _stats_np(tm)
        again = tm(torch.from_numpy(fake))
    side = {28: 1, 32: 2}[shape[1]]
    assert tuple(got_r.shape) == (shape[0], side, side, 1)
    np.testing.assert_allclose(got_r.numpy(), np.asarray(want_r), **TOL)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), **TOL)
    for bn in moved:
        for key in ("mean", "var"):
            np.testing.assert_allclose(moved[bn][key], np.asarray(want_stats[bn][key]),
                                       rtol=1e-5, atol=1e-5, err_msg=f"{bn} {key}")
            np.testing.assert_array_equal(_stats_np(tm)[bn][key], moved[bn][key])
    np.testing.assert_array_equal(again.numpy(), got_f.numpy())


def test_init_weights_follow_the_reference():
    """Conv weights N(0, 0.02), BN scales N(1, 0.02), biases 0, running
    statistics 0 and 1; the same generator seed gives the same weights."""
    a, b = TorchDisc(1), TorchDisc(1)
    a.init_weights(torch.Generator().manual_seed(5))
    b.init_weights(torch.Generator().manual_seed(5))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.model[5].weight
    assert abs(w.mean().item()) < 2e-3 and abs(w.std().item() - 0.02) < 1e-3
    bn = a.model[6]
    assert abs(bn.weight.mean().item() - 1.0) < 5e-3 and not bn.bias.any()
    assert not bn.running_mean.any() and torch.equal(bn.running_var, torch.ones(256))
    assert not a.model[0].bias.any() and not a.model[11].bias.any()

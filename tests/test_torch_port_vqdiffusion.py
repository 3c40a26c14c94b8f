"""The port's gaussian3d VQ-diffusion serving path against the JAX package's:
the U-Net's weight map, the BN-folded forward, the decoder's bilinear
upsample, ``VQDiffusionComposite.sample`` with the JAX package's noise
injected, and the entry point on the CPU. Geometry: tests/conftest.py's
tiny_config (latent 8 -> 64 tokens, vocab 64, gaussian_dim 16) with 3 DDPM
steps and the U-Net cut to base 16, mults (1, 2); the chain against JAX's
cuts it to mults (1,), which halves the JAX compile. The JAX chain and the
flax forward each run under one ``jax.jit``.

Tolerances: the folded U-Net within 2e-4 of the flax module, as the JAX
package's own tests/test_shuffle_packed.py holds its folded forward; the
resize within 1e-6 (the same four weights a pixel); indices identical.
"""

import glob

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_diffusion import _jax_noise
from test_torch_port_shuffle import numpy_variables
from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.models import shuffle_infer
from vq_vae_gan_diffusion_torch.models.shuffle_infer import (apply_folded, fold_unet,
                                                             resolve_sampler_mode)
from vq_vae_gan_diffusion_torch.models.unet_shuffle import ShuffleUNet as TorchUNet
from vq_vae_gan_diffusion_torch.models.unet_shuffle import upsample_to
from vq_vae_gan_diffusion_torch.models.vq_diffusion_composite import (
    VQDiffusionComposite as TorchComposite)
from vq_vae_gan_diffusion_torch.ops.shuffle import fused_downsample
from vq_vae_gan_diffusion_torch.train import VQDiffusionWorker
from vq_vae_gan_diffusion_torch.weights import shuffle_unet_state_from_jax
from vq_vae_gan_diffusion_tpu.models.unet_shuffle import ShuffleUNet
from vq_vae_gan_diffusion_tpu.models.vq_diffusion_composite import (
    VQDiffusionComposite as JaxComposite)
from vq_vae_gan_diffusion_tpu.utils.torch_export import export_shuffle_unet


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more,
    and with every core busy (several test workers) the unfused U-Net's
    convolutions run many times slower on a full thread pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _vqdiffusion(tiny_config, log_dir=None, **overrides) -> dict:
    data = tiny_config.to_dict()
    data["architecture"]["model_name"] = "vqdiffusion"
    data["architecture"]["vqdiffusion"].update({"unet_base_dim": 16, "unet_dim_mults": [1, 2],
                                                "diffusion_steps": 3, **overrides})
    if log_dir is not None:
        data["trainer"]["log_dir"] = str(log_dir)
    return data


@pytest.fixture(scope="module")
def unets():
    unet = ShuffleUNet(timesteps=10, time_embedding_dim=32, in_channels=1, out_channels=1,
                       base_dim=16, dim_mults=(1, 2))
    x = np.random.RandomState(0).standard_normal((2, 32, 16, 1)).astype(np.float32)
    t = np.array([3, 7], np.int32)
    variables = numpy_variables(unet, 1, jnp.asarray(x), None, jnp.asarray(t))
    want = np.asarray(jax.jit(lambda v, x, t: unet.apply(v, x, None, t, train=False))(
        variables, jnp.asarray(x), jnp.asarray(t)))
    port = TorchUNet(10, 32, 1, 1, 16, (1, 2))
    port.load_state_dict(shuffle_unet_state_from_jax(variables["params"],
                                                     variables["batch_stats"]), strict=True)
    return variables, port.eval(), x, t, want


def test_unet_state_matches_export(unets):
    variables, port, *_ = unets
    got = shuffle_unet_state_from_jax(variables["params"], variables["batch_stats"])
    want = export_shuffle_unet(variables["params"], variables["batch_stats"])
    assert list(got) == list(want)
    assert set(got) == set(port.state_dict())
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_folded_unet_matches_flax(unets):
    _, port, x, t, want = unets
    xt, tt = torch.from_numpy(x), torch.from_numpy(t).long()
    with torch.no_grad():
        module_out = port(xt, None, tt)
    folded_out = apply_folded(fold_unet(port), xt, tt)
    assert tuple(folded_out.shape) == want.shape == (2, 32, 16, 1)
    np.testing.assert_allclose(folded_out.numpy(), want, atol=2e-4)
    np.testing.assert_allclose(module_out.numpy(), want, atol=2e-4)


def test_folded_unet_on_odd_grid_matches_module(unets, monkeypatch):
    """Odd grids (the mnist config's 49-token side) go through the
    downsample wrapper like even ones, each halving to ceil(H/2)."""
    _, port, *_ = unets
    grids = []

    def counted(x, folded):
        grids.append(tuple(x.shape[1:3]))
        return fused_downsample(x, folded)
    monkeypatch.setattr(shuffle_infer, "fused_downsample", counted)
    x = torch.from_numpy(np.random.RandomState(3).standard_normal((2, 13, 7, 1)).astype(np.float32))
    t = torch.tensor([1, 8])
    with torch.no_grad():
        want = port(x, None, t)
    got = apply_folded(fold_unet(port), x, t)
    assert grids == [(13, 7), (7, 4)]
    assert tuple(got.shape) == (2, 13, 7, 1)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)


@pytest.mark.parametrize("size,out", [((4, 3), (8, 6)), ((16, 6), (32, 12)), ((4, 2), (7, 3))])
def test_bilinear_upsample_matches_jax(size, out):
    """The decoder's resize to its skip's size: 2x on the even grids of the
    path, and an odd skip (mnist's 7x7 token grid)."""
    x = np.random.RandomState(2).standard_normal((2, *size, 5)).astype(np.float32)
    want = jax.image.resize(jnp.asarray(x), (2, *out, 5), method="bilinear")
    got = upsample_to(torch.from_numpy(x).permute(0, 3, 1, 2), out).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)


def test_composite_sample_matches_jax(tiny_config):
    """The gaussian3d chain (3 clipped DDPM steps) and cosine argmax give the
    JAX package's indices, on its weights and noise, by both port routes."""
    data = _vqdiffusion(tiny_config, unet_dim_mults=[1])
    jcomp = JaxComposite(tiny_config.__class__(data))
    n, d = jcomp.seq_len, jcomp.gaussian_dim
    variables = jax.tree_util.tree_map(jnp.asarray, numpy_variables(
        jcomp.unet, 3, jnp.zeros((1, n, d, 1)), None, jnp.zeros((1,), jnp.int32)))
    want = np.asarray(jax.jit(jcomp.sample, static_argnums=3)(
        variables["params"], variables["batch_stats"], jax.random.PRNGKey(4), 2))
    x_t, noise = _jax_noise(jax.random.PRNGKey(4), (2, n, d, 1), jcomp.timesteps)
    for fused in (True, False):
        port = TorchComposite(t_config_from_dict(_vqdiffusion(tiny_config, unet_dim_mults=[1],
                                                              fused_sampler=fused)))
        port.unet.load_state_dict(shuffle_unet_state_from_jax(variables["params"],
                                                              variables["batch_stats"]))
        got = port.eval().sample(2, x_T=x_t, step_noise=noise)
        assert tuple(got.shape) == (2, 64)
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"fused_sampler={fused}")


def _write_config(tmp_path, tiny_config, **overrides) -> str:
    path = tmp_path / "tiny_vqdiffusion.yml"
    path.write_text(yaml.safe_dump(_vqdiffusion(tiny_config, tmp_path / "logs", **overrides)))
    return str(path)


def test_generate_cli_on_cpu_writes_grid(tmp_path, tiny_config):
    """Both sampler routes through the entry point: a grid, indices in the
    vocabulary, finite images, and (same seed) the same indices."""
    cfg_path = _write_config(tmp_path, tiny_config)
    outs = {}
    for mode in ("on", "off"):
        outs[mode] = generate.run(["--config", cfg_path, "--n-samples", "2", "--device", "cpu",
                                   "--fused-sampler", mode])
        idx, images = outs[mode]["indices"], outs[mode]["images"]
        assert tuple(idx.shape) == (2, 64) and 0 <= int(idx.min()) and int(idx.max()) < 64
        assert tuple(images.shape) == (2, 32, 32, 3) and torch.isfinite(images).all()
        grids = glob.glob(str(tmp_path / "logs" / "*" / "vqdiffusion_generate" / "run_*" /
                              "samples_epoch0.jpg"))
        assert outs[mode]["path"] in grids
    assert torch.equal(outs["on"]["indices"], outs["off"]["indices"])


def test_generate_loads_port_checkpoint(tmp_path, tiny_config):
    """--ckpt loads {"vqvae", "unet"}: the run samples and decodes with the
    checkpoint's weights, not the seeded init's."""
    cfg_path = _write_config(tmp_path, tiny_config)
    cfg = t_config_from_dict(_vqdiffusion(tiny_config, tmp_path / "logs"))
    other = VQDiffusionWorker(cfg, str(tmp_path), seed=9, device="cpu")
    other.init_state()
    ckpt = str(tmp_path / "ckpt.pt")
    torch.save({"vqvae": other.composite.vqvae.state_dict(),
                "unet": other.composite.unet.state_dict()}, ckpt)
    out = generate.run(["--config", cfg_path, "--n-samples", "2", "--device", "cpu",
                        "--seed", "1", "--ckpt", ckpt])
    want = other.composite.sample(2, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(out["indices"], want)
    torch.testing.assert_close(out["images"], other.composite.z_to_image(want))


def test_generate_cli_without_gpu_raises(tmp_path, tiny_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = _write_config(tmp_path, tiny_config)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--config", cfg_path, "--n-samples", "2"])


@pytest.mark.parametrize("diffusion_type,slice_", [("VQ_Official", "slice 7"),
                                                   ("gaussiandiffusion2d", "slice 7")])
def test_other_priors_not_ported(tiny_config, diffusion_type, slice_):
    """The VQ_Official prior is ported with its ShuffleNet U-Net; its Unet1D
    branch (unet_dim 2) and gaussiandiffusion2d are not."""
    cfg = t_config_from_dict(_vqdiffusion(tiny_config, diffusion_type=diffusion_type,
                                          unet_dim=2))
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md, {slice_}"):
        TorchComposite(cfg)


def test_resolve_sampler_mode():
    for mode in (True, "true", "on", "pallas", "packed"):
        assert resolve_sampler_mode(mode) is True
    for mode in (False, "off", "false", None, 0):
        assert resolve_sampler_mode(mode) is False
    with pytest.raises(ValueError, match="removed"):
        resolve_sampler_mode("chain")

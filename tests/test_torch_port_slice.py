"""The port's stage-2 serving path as a whole against the JAX package's, at
tests/conftest.py::tiny_config (C=32, L=2, H=4, latent 8, vocab 64, 32x32
images), and its entry point on the CPU.
"""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.config import load_config as t_load_config
from vq_vae_gan_diffusion_torch.models.vq_transformer import VQTransformer as TorchVQT
from vq_vae_gan_diffusion_torch.train import VQTransformerWorker
from vq_vae_gan_diffusion_torch.weights import gpt_state_from_jax, vqvae_state_from_jax
from vq_vae_gan_diffusion_tpu.config import load_config as j_load_config
from vq_vae_gan_diffusion_tpu.models.vq_transformer import VQTransformer as JaxVQT

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _stage2(tiny_config, log_dir=None) -> dict:
    data = tiny_config.to_dict()
    data["architecture"]["model_name"] = "vqvae_transformer"
    if log_dir is not None:
        data["trainer"]["log_dir"] = str(log_dir)
    return data


@pytest.fixture(scope="module")
def composites(tiny_config):
    jcfg = tiny_config.replace_path("architecture.model_name", "vqvae_transformer")
    tcfg = t_config_from_dict(jcfg.to_dict())
    jvqt = JaxVQT(jcfg)
    x = np.random.RandomState(0).standard_normal((2, 32, 32, 3)).astype(np.float32)
    vq_params = jax.jit(jvqt.vqvae.init)(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    gpt_params = jvqt.gpt.init(jax.random.PRNGKey(1), jnp.zeros((1, 8), jnp.int32))["params"]
    gpt_params = jax.tree_util.tree_map(
        lambda p: p + 0.02 * jnp.sin(jnp.arange(p.size, dtype=jnp.float32)).reshape(p.shape),
        gpt_params)
    # a wide logit spread, so near-ties cannot decide quasi-greedy sampling
    gpt_params["head"]["kernel"] = gpt_params["head"]["kernel"] * 50.0
    vq_params, gpt_params = jax.device_get(vq_params), jax.device_get(gpt_params)
    tvqt = TorchVQT(tcfg)
    tvqt.vqvae.load_state_dict(vqvae_state_from_jax(vq_params, tcfg), strict=True)
    tvqt.gpt.load_state_dict(gpt_state_from_jax(gpt_params), strict=True)
    return jvqt, vq_params, gpt_params, tvqt.eval(), x


def test_sample_and_decode_match_jax(composites):
    """VQTransformer.sample -> z_to_image: identical tokens at temperature 1e-4
    and images within 1e-4."""
    jvqt, vq_params, gpt_params, tvqt, _ = composites
    want_tok = jvqt.sample(gpt_params, jax.random.PRNGKey(5), 2, temperature=1e-4, top_k=10)
    got_tok = tvqt.sample(2, temperature=1e-4, top_k=10,
                          generator=torch.Generator().manual_seed(5))
    assert tuple(got_tok.shape) == (2, 64)
    np.testing.assert_array_equal(got_tok.numpy(), np.asarray(want_tok))
    want_img = jvqt.z_to_image(vq_params, want_tok)
    got_img = tvqt.z_to_image(got_tok)
    assert tuple(got_img.shape) == (2, 32, 32, 3)
    np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img), rtol=1e-4, atol=1e-4)


def test_encode_to_z_matches_jax(composites):
    jvqt, vq_params, _, tvqt, x = composites
    jz, jidx = jvqt.encode_to_z(vq_params, jnp.asarray(x))
    tz, tidx = tvqt.encode_to_z(torch.from_numpy(x))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(tz.numpy(), np.asarray(jz), rtol=1e-4, atol=1e-4)


def test_sample_with_start_indices_matches_jax(composites):
    """Half-prefix completion: the given indices are teacher-forced."""
    jvqt, _, gpt_params, tvqt, _ = composites
    start = np.random.RandomState(6).randint(0, 64, (2, 32)).astype(np.int32)
    want = jvqt.sample(gpt_params, jax.random.PRNGKey(2), 2, start_indices=jnp.asarray(start),
                       steps=32, temperature=1e-4, top_k=10)
    got = tvqt.sample(2, start_indices=torch.from_numpy(start), steps=32, temperature=1e-4,
                      top_k=10, generator=torch.Generator().manual_seed(2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _write_config(tmp_path, tiny_config) -> str:
    path = tmp_path / "tiny.yml"
    path.write_text(yaml.safe_dump(_stage2(tiny_config, tmp_path / "logs")))
    return str(path)


def test_generate_cli_on_cpu_writes_grid(tmp_path, tiny_config):
    cfg_path = _write_config(tmp_path, tiny_config)
    assert generate.main(["--config", cfg_path, "--n-samples", "4", "--device", "cpu"]) == 0
    grids = glob.glob(str(tmp_path / "logs" / "*" / "*_generate" / "run_*" /
                          "samples_epoch0.jpg"))
    assert len(grids) == 1
    from PIL import Image
    assert Image.open(grids[0]).size == (2 + 4 * 34, 2 + 34)


def test_generate_loads_port_checkpoint(tmp_path, tiny_config):
    """--ckpt loads a port checkpoint: the images decode the sampled tokens
    with the checkpoint's VQVAE, not the seeded init's."""
    cfg_path = _write_config(tmp_path, tiny_config)
    cfg = t_config_from_dict(_stage2(tiny_config, tmp_path / "logs"))
    other = VQTransformerWorker(cfg, str(tmp_path), seed=9, device="cpu")
    other.init_state()
    ckpt = str(tmp_path / "ckpt.pt")
    torch.save({"vqvae": other.composite.vqvae.state_dict(),
                "gpt": other.composite.gpt.state_dict()}, ckpt)
    out = generate.run(["--config", cfg_path, "--n-samples", "2", "--device", "cpu",
                        "--seed", "1", "--ckpt", ckpt])
    torch.testing.assert_close(out["images"], other.composite.z_to_image(out["tokens"]))


def test_generate_cli_without_gpu_raises(tmp_path, tiny_config, monkeypatch):
    """No GPU and no --device cpu: the CLI refuses instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = _write_config(tmp_path, tiny_config)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        generate.main(["--config", cfg_path, "--n-samples", "2"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        VQTransformerWorker(t_config_from_dict(_stage2(tiny_config)), str(tmp_path),
                            device="cuda")


def test_generate_other_models_not_ported(tmp_path, tiny_config):
    path = tmp_path / "vqgan.yml"
    data = _stage2(tiny_config, tmp_path / "logs")
    data["architecture"]["model_name"] = "vqgan"
    path.write_text(yaml.safe_dump(data))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        generate.main(["--config", str(path), "--device", "cpu"])


@pytest.mark.parametrize("name", sorted(os.path.basename(p) for p in
                                        glob.glob(os.path.join(ROOT, "configs", "*.yml"))))
def test_config_parses_every_yaml_like_jax(name):
    path = os.path.join(ROOT, "configs", name)
    assert t_load_config(path).to_dict() == j_load_config(path).to_dict()

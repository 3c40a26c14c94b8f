"""The port's checkpoint loading (``vq_vae_gan_diffusion_torch/checkpoint.py``)
and its entry point's ``--fused-sampler`` override, at
tests/conftest.py::tiny_config.

JAX parameters drawn with numpy (from ``jax.eval_shape``, no compile) are
exported to bare ``state_dict``s by the JAX package's
``utils/torch_export`` and written with the export tool's own
``_tensorize``, as ``tools/export_torch_checkpoint.py`` writes them from an
Orbax checkpoint. ``generate.run`` serving them on the CPU must give the
outputs of the transplanted route (``weights.py``'s maps loaded into a
worker of the same seed): tokens and indices equal, images equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_shuffle import numpy_variables
from tools.export_torch_checkpoint import _tensorize
from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch.checkpoint import EXPORT_TOOL
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.train import VQDiffusionWorker, VQTransformerWorker
from vq_vae_gan_diffusion_torch.weights import (gpt_state_from_jax, shuffle_unet_state_from_jax,
                                                vqvae_state_from_jax)
from vq_vae_gan_diffusion_tpu.models.vq_diffusion_composite import (
    VQDiffusionComposite as JaxComposite)
from vq_vae_gan_diffusion_tpu.models.vq_transformer import VQTransformer as JaxVQT
from vq_vae_gan_diffusion_tpu.utils import torch_export as te


def _draw(shapes, seed: int):
    """Leaves of ``shapes`` drawn with numpy: kernels N(0, 1/fan_in),
    embeddings N(0, 1/width), LayerNorm/GroupNorm scales near 1, the rest
    N(0, 0.1^2)."""
    rs = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            v = rs.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif name in ("embedding", "pos_emb"):
            v = rs.standard_normal(shape) / np.sqrt(shape[-1])
        elif name == "scale":
            v = 1.0 + 0.1 * rs.standard_normal(shape)
        else:
            v = 0.1 * rs.standard_normal(shape)
        return v.astype(np.float32)
    return jax.tree_util.tree_map_with_path(draw, shapes)


def _data(tiny_config, model_name: str, log_dir, **vqdiffusion) -> dict:
    data = tiny_config.to_dict()
    data["architecture"]["model_name"] = model_name
    data["architecture"]["vqdiffusion"].update({"unet_base_dim": 16, "unet_dim_mults": [1, 2],
                                                "diffusion_steps": 3, **vqdiffusion})
    data["trainer"]["log_dir"] = str(log_dir)
    return data


def _write(tmp_path, data: dict, **resume) -> str:
    """The config with ``architecture.<key>.resume_path`` set from ``resume``."""
    data = yaml.safe_load(yaml.safe_dump(data))
    for key, path in resume.items():
        data["architecture"][key]["resume_path"] = str(path)
    path = tmp_path / "config.yml"
    path.write_text(yaml.safe_dump(data))
    return str(path)


@pytest.fixture(scope="module")
def jax_params(tiny_config):
    """(VQVAE params, GPT params, U-Net variables) of the tiny geometry."""
    jvqt = JaxVQT(tiny_config.replace_path("architecture.model_name", "vqvae_transformer"))
    vq = _draw(jax.eval_shape(lambda: jvqt.vqvae.init(jax.random.PRNGKey(0),
                                                      jnp.zeros((1, 32, 32, 3))))["params"], 0)
    gpt = _draw(jax.eval_shape(lambda: jvqt.gpt.init(jax.random.PRNGKey(1),
                                                     jnp.zeros((1, 8), jnp.int32)))["params"], 1)
    jcomp = JaxComposite(tiny_config.__class__(_data(tiny_config, "vqdiffusion", "logs")))
    n, d = jcomp.seq_len, jcomp.gaussian_dim
    unet = numpy_variables(jcomp.unet, 2, jnp.zeros((1, n, d, 1)), None,
                           jnp.zeros((1,), jnp.int32))
    return vq, gpt, unet


def _geometry(tiny_config) -> dict:
    vq = tiny_config.architecture.vqvae
    return dict(img_size=32, latent_size=int(vq.latent_size),
                intermediate_channels=list(vq.intermediate_channels),
                n_res_encoder=int(vq.num_residual_blocks_encoder),
                n_res_decoder=int(vq.num_residual_blocks_decoder),
                attn_res=list(vq.attention_resolution))


@pytest.fixture(scope="module")
def exported(tiny_config, jax_params, tmp_path_factory):
    """The three bare .pth files, as the export tool writes them."""
    vq, gpt, unet = jax_params
    root = tmp_path_factory.mktemp("exported")
    files = {"vqvae": (te.export_vqvae(vq, **_geometry(tiny_config))),
             "gpt": te.export_gpt(gpt),
             "unet": te.export_shuffle_unet(unet["params"], unet["batch_stats"])}
    for name, sd in files.items():
        torch.save(_tensorize(sd), str(root / f"{name}.pth"))
    return {name: root / f"{name}.pth" for name in files}


@pytest.mark.parametrize("route", ["resume_path", "ckpt"])
def test_exported_gpt_and_vqvae_serve_like_transplant(tmp_path, tiny_config, jax_params,
                                                      exported, route):
    """The bare VQVAE from architecture.vqvae.resume_path and the bare minGPT
    from architecture.vqvae_transformer.resume_path or --ckpt: the tokens
    and images of the transplanted weights."""
    vq, gpt, _ = jax_params
    data = _data(tiny_config, "vqvae_transformer", tmp_path / "logs")
    resume = {"vqvae": exported["vqvae"]}
    argv = ["--n-samples", "2", "--device", "cpu", "--seed", "3"]
    if route == "ckpt":
        argv += ["--ckpt", str(exported["gpt"])]
    else:
        resume["vqvae_transformer"] = exported["gpt"]
    out = generate.run(["--config", _write(tmp_path, data, **resume)] + argv)

    cfg = t_config_from_dict(data)
    want = VQTransformerWorker(cfg, str(tmp_path), seed=3, device="cpu")
    want.init_state()
    want.composite.vqvae.load_state_dict(vqvae_state_from_jax(vq, cfg), strict=True)
    want.composite.gpt.load_state_dict(gpt_state_from_jax(gpt), strict=True)
    ref = want.generate_images(n_samples=2)
    assert torch.equal(out["tokens"], ref["tokens"])
    assert torch.equal(out["images"], ref["images"])


def test_exported_shuffle_unet_serves_like_transplant(tmp_path, tiny_config, jax_params,
                                                      exported):
    """A bare ShuffleNet-denoiser state_dict through --ckpt on the gaussian3d
    path: the indices and images of the transplanted U-Net."""
    _, _, unet = jax_params
    data = _data(tiny_config, "vqdiffusion", tmp_path / "logs")
    out = generate.run(["--config", _write(tmp_path, data), "--n-samples", "2",
                        "--device", "cpu", "--seed", "4", "--ckpt", str(exported["unet"])])
    want = VQDiffusionWorker(t_config_from_dict(data), str(tmp_path), seed=4, device="cpu")
    want.init_state()
    want.composite.unet.load_state_dict(
        shuffle_unet_state_from_jax(unet["params"], unet["batch_stats"]), strict=True)
    ref = want.generate_images(n_samples=2)
    assert torch.equal(out["indices"], ref["indices"])
    assert torch.equal(out["images"], ref["images"])


def _bad_path(tmp_path, kind: str) -> str:
    if kind == "directory":
        (tmp_path / "ckpt").mkdir()
        (tmp_path / "ckpt" / "_CHECKPOINT_METADATA").write_text("{}")
        return str(tmp_path / "ckpt")
    path = tmp_path / "bad.pth"
    if kind == "not torch":
        path.write_text("not a checkpoint")
    else:   # a state_dict of no module the port serves
        torch.save({"fc.weight": torch.zeros(2, 2)}, str(path))
    return str(path)


@pytest.mark.parametrize("where,kind", [("vqvae", "directory"),
                                        ("vqvae_transformer", "directory"),
                                        ("ckpt", "directory"),
                                        ("ckpt", "not torch"),
                                        ("vqvae", "unknown state_dict")])
def test_existing_unreadable_checkpoint_raises(tmp_path, tiny_config, where, kind):
    """A path that exists but is a directory (an Orbax checkpoint) or a file
    of no known form raises, naming the export tool, instead of serving
    seeded weights."""
    bad = _bad_path(tmp_path, kind)
    data = _data(tiny_config, "vqvae_transformer", tmp_path / "logs")
    argv = ["--n-samples", "2", "--device", "cpu"]
    if where == "ckpt":
        cfg = _write(tmp_path, data)
        argv += ["--ckpt", bad]
    else:
        cfg = _write(tmp_path, data, **{where: bad})
    with pytest.raises(ValueError, match=EXPORT_TOOL):
        generate.run(["--config", cfg] + argv)


def test_missing_checkpoint_warns_and_serves(tmp_path, tiny_config, caplog):
    """Paths where nothing exists (the shipped configs' zlog/... paths on a
    fresh machine) only warn: the run serves the seeded weights."""
    data = _data(tiny_config, "vqvae_transformer", tmp_path / "logs")
    cfg = _write(tmp_path, data, vqvae=tmp_path / "no" / "vqgan" / "ckpt",
                 vqvae_transformer=tmp_path / "no" / "gpt" / "ckpt")
    out = generate.run(["--config", cfg, "--n-samples", "2", "--device", "cpu", "--seed", "5"])
    missing = [r.getMessage() for r in caplog.records if "not found" in r.getMessage()]
    assert len(missing) == 2, missing
    seeded = generate.run(["--config", _write(tmp_path, data), "--n-samples", "2",
                           "--device", "cpu", "--seed", "5"])
    assert torch.equal(out["tokens"], seeded["tokens"])


@pytest.mark.parametrize("mode", ["on", "off"])
def test_fused_sampler_sets_trainer_keys(tmp_path, tiny_config, monkeypatch, mode):
    """--fused-sampler sets architecture.vqdiffusion.fused_sampler and, as
    the root generate.py, trainer.{gaussiandiffusion3d,vqdiffusion}.fused_sampler
    where the config has them (and adds no trainer section it lacks)."""
    seen = {}

    def fake_generate(self, val_loader=None, n_samples=16, epoch=0):
        seen["config"] = self.config
        return {}
    monkeypatch.setattr(VQDiffusionWorker, "generate_images", fake_generate)
    data = _data(tiny_config, "vqdiffusion", tmp_path / "logs")
    del data["trainer"]["gaussiandiffusion3d"]
    generate.run(["--config", _write(tmp_path, data), "--device", "cpu",
                  "--fused-sampler", mode])
    cfg = seen["config"]
    assert cfg.architecture.vqdiffusion.fused_sampler is (mode == "on")
    assert cfg.trainer.vqdiffusion.fused_sampler is (mode == "on")
    assert "gaussiandiffusion3d" not in cfg.trainer

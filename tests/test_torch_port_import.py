"""The reference's training files through the port's import CLI
(``vq_vae_gan_diffusion_torch/import_checkpoint.py`` over
``checkpoint.reference_parts``) against the JAX package's import
(``utils/torch_import`` and ``tools/import_torch_checkpoint.py``), at
tests/conftest.py::tiny_config.

Each reference form is built from the JAX package's ``export_*`` output of
JAX parameters drawn with numpy, wrapped as the reference saves it: stage 1's
bare VQVAE and its separate discriminator file, the VAE's
``{"vae_state_dict", "optimizer_state_dict"}``, the bare minGPT, the
discrete priors' ``{"diffusion", "optimizer", "scheduler"[, "model_ema"]}``
(the denoiser under ``model.`` with the Lt and schedule buffers; the EMA as
torch's ``AveragedModel`` ``module.*`` or ema_pytorch's ``ema_model.*``),
gaussiandiffusion2d's ``{"model", "opt", "ema", ...}`` and
gaussiandiffusion3d's ``{"model", "model_ema"}``. The EMA copies are drawn
apart from the online weights, so a swap shows.

The CLI imports each on the CPU; the worker resumed from the written
checkpoint through ``architecture.<model>.resume_path`` must hold every
source tensor exactly (and ``LtState`` the Lt buffers, ``global_step`` the
``--step``), and its modules' forwards must match the flax forwards of the
parameters ``utils/torch_import.convert_*`` makes of the same file: within
1e-4 as tests/test_torch_port_{vqgan,disc,gpt,vae}.py hold these modules,
the ShuffleNet U-Net within 2e-4 as tests/test_torch_port_vqdiffusion.py
holds it, the Conv1d U-Net within 1e-5. The VQ_Official prior's ShuffleNet
U-Net, which the composites build at base 64 whatever the config says, is
cut to base 16, mults (1,) on the port's side, as
tests/test_torch_port_discrete_train.py cuts it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from test_torch_port_ckpt import _draw, _geometry
from test_torch_port_disc import _variables as disc_variables
from test_torch_port_discrete import _vqofficial
from test_torch_port_shuffle import numpy_variables
from test_torch_port_vae import BATCH as VAE_BATCH
from test_torch_port_vae import _eps, _vae_config
from test_torch_port_vae import _geometry as vae_geometry
from tools.export_torch_checkpoint import _tensorize
from tools.import_torch_checkpoint import _to_numpy, _unet_from_diffusion, _unwrap_ema
from vq_vae_gan_diffusion_torch import generate, import_checkpoint
from vq_vae_gan_diffusion_torch.checkpoint import DISCRETE_SCHEDULE_BUFFERS
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.models import vq_diffusion_composite as t_comp_mod
from vq_vae_gan_diffusion_torch.train import cli, worker_class
from vq_vae_gan_diffusion_tpu.config import config_from_dict as j_config_from_dict
from vq_vae_gan_diffusion_tpu.models.discriminator import Discriminator as JaxDisc
from vq_vae_gan_diffusion_tpu.models.mingpt import GPT as JaxGPT
from vq_vae_gan_diffusion_tpu.models.unet1d import Unet1D as JaxUnet1D
from vq_vae_gan_diffusion_tpu.models.unet_shuffle import ShuffleUNet as JaxUNet
from vq_vae_gan_diffusion_tpu.models.vae import VAE as JaxVAE
from vq_vae_gan_diffusion_tpu.models.vq_diffusion_composite import (
    VQDiffusionComposite as JaxComposite)
from vq_vae_gan_diffusion_tpu.models.vqvae import VQVAE as JaxVQVAE
from vq_vae_gan_diffusion_tpu.utils import torch_export as te
from vq_vae_gan_diffusion_tpu.utils import torch_import as ti

STEP = 7
TOL = dict(rtol=1e-4, atol=1e-4)
SHUFFLE_TOL = dict(rtol=0, atol=2e-4)
UNET1D_TOL = dict(rtol=1e-5, atol=1e-5)
# the one-level ShuffleNet U-Net the port's VQ_Official composite builds here
VQO_BASE, VQO_MULTS = 16, (1,)
# the resume_path each family's worker resumes from
RESUME_KEY = {"vqgan": "vqvae", "vae": "vae", "vqvae_transformer": "vqvae_transformer",
              "vqdiffusion": "vqdiffusion", "gaussiandiffusion2d": "gaussiandiffusion2d",
              "gaussiandiffusion3d": "gaussiandiffusion3d"}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, scope="module")
def small_vqofficial_unet():
    """The port's VQ_Official composite builds its ShuffleNet U-Net at base
    16, mults (1,)."""
    with pytest.MonkeyPatch.context() as mp:
        full = t_comp_mod.ShuffleUNet
        mp.setattr(t_comp_mod, "ShuffleUNet",
                   lambda T, emb, c_in, c_out, base, mults, _f=full, **kw:
                   _f(T, emb, c_in, c_out, VQO_BASE, VQO_MULTS, **kw))
        yield


def _np(sd: dict) -> dict:
    return {k: np.asarray(v) for k, v in sd.items()}


def _under(prefix: str, sd: dict) -> dict:
    return {f"{prefix}{k}": v for k, v in sd.items()}


def _ema_wrapper(sd: dict, kind: str, online: dict) -> dict:
    """``sd`` as an EMA wrapper's state_dict: torch's AveragedModel or
    ema_pytorch's (which also holds the online module)."""
    if kind == "module":
        return {"n_averaged": torch.tensor(5), **_under("module.", sd)}
    return {"initted": torch.tensor(True), "step": torch.tensor(9),
            **_under("ema_model.", sd), **_under("online_model.", online)}


def _discrete(denoiser: dict, timesteps: int, seed: int, lt: bool = True) -> dict:
    """The reference's discrete diffusion state_dict: the denoiser under
    ``model.``, the schedule buffers, and (``lt``) the Lt buffers."""
    rs = np.random.RandomState(seed)
    sd = {**_under("model.", denoiser),
          **{k: torch.from_numpy(rs.standard_normal(4).astype(np.float32))
             for k in DISCRETE_SCHEDULE_BUFFERS}}
    if lt:
        sd["Lt_history"] = torch.from_numpy(rs.uniform(0, 2, timesteps).astype(np.float32))
        sd["Lt_count"] = torch.from_numpy(rs.randint(0, 20, timesteps).astype(np.float32))
    return sd


def _gaussian(denoiser: dict) -> dict:
    """The reference's Gaussian diffusion state_dict: the denoiser under
    ``model.`` and its schedule buffers."""
    return {**_under("model.", denoiser), "betas": torch.linspace(1e-4, 0.02, 8),
            "alphas_cumprod": torch.linspace(1, 0.1, 8)}


def _opt() -> dict:
    return {"state": {}, "param_groups": [{"lr": 1e-4, "params": [0, 1]}]}


# -- the forms, each with its sources and the flax forwards of convert_*'s params ---------------

def _stage1(tiny_config):
    data = tiny_config.to_dict()
    data["architecture"]["model_name"] = "vqgan"
    jcfg = j_config_from_dict(data)
    jvq = JaxVQVAE.from_config(jcfg)
    x = np.random.RandomState(3).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    vq = _draw(jax.eval_shape(lambda: jvq.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3))))
               ["params"], 0)
    dparams, dstats = disc_variables((1, 32, 32, 3), 1)
    raw = _tensorize(te.export_vqvae(vq, **_geometry(tiny_config)))
    disc = _tensorize(te.export_discriminator(dparams, dstats))

    def check(state):
        params = ti.convert_vqvae(_np(raw), **_geometry(tiny_config))
        dec, idx, _ = jax.jit(lambda p, x: jvq.apply({"params": p}, x))(params, x)
        dp, ds = ti.convert_discriminator(_np(disc))
        # the discriminator runs on batch statistics, as the JAX worker calls it
        logits = jax.jit(lambda p, s, x: JaxDisc().apply({"params": p, "batch_stats": s}, x,
                                                         train=True,
                                                         mutable=["batch_stats"])[0])(dp, ds, x)
        with torch.no_grad():
            got_dec, got_idx, _ = state.vqvae(torch.from_numpy(x))
            got_logits = state.disc(torch.from_numpy(x))
        np.testing.assert_allclose(got_dec.numpy(), np.asarray(dec), **TOL)
        np.testing.assert_array_equal(got_idx.numpy(), np.asarray(idx))
        np.testing.assert_allclose(got_logits.numpy(), np.asarray(logits), **TOL)
    return data, raw, disc, {"vqvae": raw, "disc": disc}, check


def _vae(tiny_config):
    cfg = _vae_config(tiny_config)
    model = JaxVAE.from_config(cfg)
    params = _draw(jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), jax.random.PRNGKey(1)))["params"], 2)
    state_dict = _tensorize(te.export_vae(params, **vae_geometry(cfg)))
    raw = {"vae_state_dict": state_dict, "optimizer_state_dict": _opt()}
    x = np.random.RandomState(4).uniform(-1, 1, (VAE_BATCH, 32, 32, 3)).astype(np.float32)
    key = jax.random.PRNGKey(7)

    def check(state):
        sd = _np(raw["vae_state_dict"])
        converted = ti.convert_vae(sd, **vae_geometry(cfg))
        want = jax.jit(lambda p, x, r: model.apply({"params": p}, x, r))(converted, x, key)
        with torch.no_grad():
            got = state.vae.eval()(torch.from_numpy(x), eps=_eps(key))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    return cfg.to_dict(), raw, None, {"vae": state_dict}, check


def _gpt(tiny_config):
    data = tiny_config.to_dict()
    data["architecture"]["model_name"] = "vqvae_transformer"
    a = data["architecture"]["vqvae_transformer"]
    vocab = data["architecture"]["vqvae"]["num_codebook_vectors"]
    jgpt = JaxGPT(vocab_size=vocab, block_size=a["block_size"], n_layer=a["n_layer"],
                  n_head=a["n_head"], n_embd=a["n_embd"])
    params = _draw(jax.eval_shape(lambda: jgpt.init(jax.random.PRNGKey(1),
                                                    jnp.zeros((1, 8), jnp.int32)))["params"], 1)
    raw = _tensorize(te.export_gpt(params))
    idx = np.random.RandomState(5).randint(0, vocab, (2, 12)).astype(np.int32)

    def check(state):
        want = jax.jit(lambda p, i: jgpt.apply({"params": p}, i))(ti.convert_gpt(_np(raw)), idx)
        with torch.no_grad():
            got = state.gpt.eval()(torch.from_numpy(idx).long())
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    return data, raw, None, {"gpt": raw}, check


# one jitted flax forward a U-Net geometry, shared by the forms that use it
_FORWARDS: dict = {}


def _flax_forward(jax_unet, kind: str):
    """The flax U-Net's eval forward on the port's layout: [B, H, W, C] for
    the ShuffleNet U-Net, [B, C, L] for the Conv1d one (flax's [B, L, C])."""
    key = (kind, repr(jax_unet))
    if key not in _FORWARDS:
        if kind == "shuffle":
            fn = jax.jit(lambda v, x, t: jax_unet.apply(v, x, None, t, train=False))
        else:
            fn = jax.jit(lambda p, x, t: jnp.swapaxes(
                jax_unet.apply({"params": p}, jnp.swapaxes(x, 1, 2), None, t), 1, 2))
        _FORWARDS[key] = fn
    return _FORWARDS[key]


def _unet_check(jax_unet, x, t, kind: str, convert):
    """The check of a U-Net pair: the port's online and EMA U-Nets in eval
    mode against flax on ``convert()``'s (online, EMA) variables."""
    forward = _flax_forward(jax_unet, kind)

    def check(state):
        for module, variables in zip((state.unet, state.ema), convert()):
            with torch.no_grad():
                got = module.eval()(torch.from_numpy(x), None, torch.from_numpy(t).long())
            np.testing.assert_allclose(got.numpy(), np.asarray(forward(variables, x, t)),
                                       **(SHUFFLE_TOL if kind == "shuffle" else UNET1D_TOL))
    return check


def _unet_variables(kind: str, jax_unet, x, t, seed: int):
    """(export, jax variables) of a U-Net drawn with numpy."""
    if kind == "shuffle":
        v = numpy_variables(jax_unet, seed, jnp.asarray(x), None, jnp.asarray(t))
        return _tensorize(te.export_shuffle_unet(v["params"], v["batch_stats"]))
    p = _draw(jax.eval_shape(lambda: jax_unet.init(jax.random.PRNGKey(0),
                                                   jnp.asarray(np.swapaxes(x, 1, 2)), None,
                                                   jnp.asarray(t)))["params"], seed)
    return _tensorize(te.export_unet1d(p))


def _vqofficial_form(tiny_config, wrapper, unet_dim: int = 3):
    extra = {"unet_dim": 2, "unet_base_dim": 8, "unet_dim_mults": [1, 2]} if unet_dim == 2 else {}
    data = _vqofficial(tiny_config, **extra)
    jcomp = JaxComposite(j_config_from_dict(data))
    k, n, T = jcomp.codebook_size, jcomp.seq_len, jcomp.timesteps
    t = np.array([9, 2], np.int32)
    if unet_dim == 2:
        kind, jax_unet = "unet1d", jcomp.unet
        x = np.random.RandomState(6).standard_normal((2, k, n)).astype(np.float32)
    else:
        kind, jax_unet = "shuffle", JaxUNet(T, 256, 1, 1, VQO_BASE, VQO_MULTS)
        x = np.random.RandomState(6).standard_normal((2, k, n, 1)).astype(np.float32)
    online = _unet_variables(kind, jax_unet, x, t, 11)
    ema = _unet_variables(kind, jax_unet, x, t, 12)
    diffusion = _discrete(online, T, 13)
    raw = {"diffusion": diffusion, "optimizer": _opt(), "scheduler": {"last_epoch": 3}}
    if wrapper:
        raw["model_ema"] = _ema_wrapper(_discrete(ema, T, 14), wrapper, diffusion)

    def convert():
        nraw = _to_numpy(raw)
        p, s, _, _ = ti.convert_discrete_diffusion(nraw["diffusion"])
        out = [{"params": p, "batch_stats": s} if kind == "shuffle" else p]
        if "model_ema" in nraw:
            p, s, _, _ = ti.convert_discrete_diffusion(_unwrap_ema(nraw["model_ema"]))
        out.append({"params": p, "batch_stats": s} if kind == "shuffle" else p)
        return out
    sources = {"unet": online, "ema": ema if wrapper else online,
               "lt": (diffusion["Lt_history"], diffusion["Lt_count"])}
    return data, raw, None, sources, _unet_check(jax_unet, x, t, kind, convert)


def _pixel_form(tiny_config, family: str, wrapper: str):
    data = tiny_config.to_dict()
    data["architecture"]["model_name"] = family
    if family == "gaussiandiffusion3d":
        a = data["architecture"]["gaussiandiffusion3d"]
        kind = "shuffle"
        jax_unet = JaxUNet(a["diffusion_steps"], 256, 3, 3, a["model_base_dim"], (2, 4))
        x = np.random.RandomState(7).standard_normal((2, 32, 32, 3)).astype(np.float32)
    else:
        data["architecture"]["gaussiandiffusion2d"].update({"unet_base_dim": 8,
                                                            "unet_dim_mults": [1, 2]})
        kind = "unet1d"
        jax_unet = JaxUnet1D(dim=8, dim_mults=(1, 2), channels=32, out_dim=32)
        x = np.random.RandomState(7).standard_normal((2, 32, 32)).astype(np.float32)
    t = np.array([5, 1], np.int32)
    online = _unet_variables(kind, jax_unet, x, t, 21)
    ema = _unet_variables(kind, jax_unet, x, t, 22)
    model = _gaussian(online)
    ema_sd = _ema_wrapper(_gaussian(ema), wrapper, model)
    raw = ({"model": model, "opt": _opt(), "ema": ema_sd, "step": 40} if wrapper == "ema_model"
           else {"model": model, "model_ema": ema_sd})

    def convert():
        nraw = _to_numpy(raw)
        pairs = [_unet_from_diffusion(nraw["model"]),
                 _unet_from_diffusion(_unwrap_ema(nraw.get("ema") or nraw.get("model_ema")))]
        return [{"params": p, "batch_stats": s} if kind == "shuffle" else p for p, s in pairs]
    return data, raw, None, {"unet": online, "ema": ema}, _unet_check(jax_unet, x, t, kind,
                                                                      convert)


FORMS = {
    "vqgan+disc": _stage1,
    "vae": _vae,
    "gpt": _gpt,
    "vqofficial, AveragedModel EMA": lambda c: _vqofficial_form(c, "module"),
    "vqofficial, ema_pytorch EMA": lambda c: _vqofficial_form(c, "ema_model"),
    "vqofficial, no EMA": lambda c: _vqofficial_form(c, None),
    "vqofficial Conv1d": lambda c: _vqofficial_form(c, "module", unet_dim=2),
    "gaussiandiffusion3d {model, model_ema}": lambda c: _pixel_form(c, "gaussiandiffusion3d",
                                                                    "module"),
    "gaussiandiffusion2d {model, opt, ema}": lambda c: _pixel_form(c, "gaussiandiffusion2d",
                                                                   "ema_model"),
}


def _write(tmp_path, name: str, obj) -> str:
    path = tmp_path / name
    if isinstance(obj, dict) and "architecture" in obj:
        path.write_text(yaml.safe_dump(yaml.safe_load(yaml.safe_dump(obj))))
    else:
        torch.save(obj, str(path))
    return str(path)


def _import(tmp_path, data, raw, disc=None, extra=()) -> dict:
    data = dict(data, trainer=dict(data["trainer"], log_dir=str(tmp_path / "zlog")))
    argv = ["--config", _write(tmp_path, "config.yml", data), "--pth",
            _write(tmp_path, "ref.pth", raw), "--out", str(tmp_path / "imported"),
            "--step", str(STEP), "--device", "cpu", *extra]
    if disc is not None:
        argv += ["--disc-pth", _write(tmp_path, "disc.pth", disc)]
    return import_checkpoint.run(argv)


def _resumed(tmp_path, data, path: str):
    """The family's worker on the CPU, resumed from ``path`` through its
    ``resume_path``."""
    model = data["architecture"]["model_name"]
    data = yaml.safe_load(yaml.safe_dump(data))
    data["architecture"].setdefault(RESUME_KEY[model], {})["resume_path"] = path
    worker = worker_class(model)(t_config_from_dict(data), str(tmp_path / "resumed"), seed=5,
                                 device="cpu")
    worker.init_state()
    return worker


def _assert_holds(module, source: dict, what: str) -> None:
    """``module`` holds every tensor of ``source`` (the export writes
    ``num_batches_tracked`` as [1], the module keeps it as [])."""
    got = module.state_dict()
    assert set(got) == set(source), what
    for k, v in source.items():
        assert torch.equal(got[k].reshape(v.shape), v), f"{what}: {k}"


@pytest.mark.parametrize("form", list(FORMS))
def test_reference_form_imports_and_matches_jax(tmp_path, tiny_config, form):
    """The CLI loads the form strictly; resumed through ``resume_path`` the
    worker holds every source tensor, the Lt buffers and the step, and its
    modules match the flax forwards of ``convert_*``'s parameters."""
    data, raw, disc, sources, check = FORMS[form](tiny_config)
    out = _import(tmp_path, data, raw, disc)
    assert out["path"].endswith(f"step_{STEP:08d}.pth")
    worker = _resumed(tmp_path, data, out["path"])
    assert worker.global_step == STEP
    state = worker.state
    lt = sources.pop("lt", None)
    for name, source in sources.items():
        _assert_holds(getattr(state, name), source, f"{form} {name}")
    if "ema" in sources and form != "vqofficial, no EMA":
        assert not torch.equal(state.ema.state_dict()[next(iter(sources["ema"]))],
                               state.unet.state_dict()[next(iter(sources["ema"]))])
    if lt is not None:
        assert torch.equal(state.lt.Lt_history, lt[0]) and torch.equal(state.lt.Lt_count, lt[1])
        assert not state.lt.acc_ema.any() and not state.lt.keep_ema.any()
    check(state)


def _refused(tiny_config, case):
    """(config data, raw file, CLI extra args, expected exception, match)."""
    if case in ("gaussian3d VQ prior", "missing Lt", "unknown buffer", "unknown key"):
        if case == "gaussian3d VQ prior":
            data = tiny_config.to_dict()
            data["architecture"]["model_name"] = "vqdiffusion"
            data["architecture"]["vqdiffusion"].update({"unet_base_dim": 16,
                                                        "unet_dim_mults": [1]})
        else:
            data = _vqofficial(tiny_config)
        jcomp = JaxComposite(j_config_from_dict(data))
        n, k = jcomp.seq_len, jcomp.codebook_size
        shape = (1, n, jcomp.gaussian_dim, 1) if case == "gaussian3d VQ prior" else (1, k, n, 1)
        unet = (jcomp.unet if case == "gaussian3d VQ prior"
                else JaxUNet(jcomp.timesteps, 256, 1, 1, VQO_BASE, VQO_MULTS))
        denoiser = _unet_variables("shuffle", unet, np.zeros(shape, np.float32),
                                   np.zeros(1, np.int32), 3)
        diffusion = _discrete(denoiser, jcomp.timesteps, 4,
                              lt=case not in ("gaussian3d VQ prior", "missing Lt"))
        if case == "unknown buffer":
            diffusion["log_foo"] = torch.zeros(3)
        if case == "unknown key":
            diffusion["model.extra.weight"] = torch.zeros(3)
        want = {"unknown key": (RuntimeError, "extra.weight"),
                "unknown buffer": (ValueError, "log_foo")}.get(case, (ValueError, "Lt_history"))
        return data, {"diffusion": diffusion}, (), *want
    if case == "Conv1d file, ShuffleNet prior":
        data, raw, *_ = _vqofficial_form(tiny_config, None, unet_dim=2)
        return _vqofficial(tiny_config), raw, (), ValueError, "unet1d denoiser"
    if case == "disc file, vqvae family":
        data, raw, disc, *_ = _stage1(tiny_config)
        return data, raw, ("--family", "vqvae", "--disc-pth", "disc.pth"), ValueError, "disc"
    data = tiny_config.to_dict()
    data["architecture"]["model_name"] = case
    return data, {}, (), ValueError, "no checkpoint format"


@pytest.mark.parametrize("case", ["gaussian3d VQ prior", "missing Lt", "unknown buffer",
                                  "unknown key", "Conv1d file, ShuffleNet prior",
                                  "disc file, vqvae family", "c_vqdiffusion", "v_vqdiffusion"])
def test_refused_forms(tmp_path, tiny_config, case):
    """What the JAX tool refuses the port refuses: a ``vqdiffusion`` file
    without Lt buffers (the gaussian3d VQ prior's form among them, which
    the JAX tool too reads as the discrete prior's), a buffer of no known
    name, and the continuous priors; besides, strict loading refuses an
    unknown key, a denoiser of the other kind, and a discriminator file for
    a worker without one."""
    data, raw, extra, exc, match = _refused(tiny_config, case)
    if "disc.pth" in extra:
        extra = extra[:-1] + (_write(tmp_path, "disc.pth", _stage1(tiny_config)[2]),)
    if case in ("gaussian3d VQ prior", "missing Lt", "unknown buffer"):
        with pytest.raises(ValueError, match=match):
            ti.convert_discrete_diffusion(_to_numpy(raw["diffusion"]))
    with pytest.raises(exc, match=match):
        _import(tmp_path, data, raw, extra=extra)


def test_import_needs_a_gpu_unless_cpu(tmp_path, tiny_config, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data, raw, *_ = _gpt(tiny_config)
    argv = ["--config", _write(tmp_path, "config.yml", data), "--pth",
            _write(tmp_path, "ref.pth", raw), "--out", str(tmp_path / "out")]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        import_checkpoint.main(argv)


def test_cli_then_resumed_training_and_generate(tmp_path, tiny_config):
    """The VQ_Official prior end to end on the CPU: the CLI imports the
    reference's file; the train CLI resumes from it for one --debug epoch
    (two steps past --step, the Lt counts moved by 2 x batch 2); ``generate
    --ckpt`` on the imported file samples the EMA copy: the indices of the
    in-memory EMA U-Net with the same generator."""
    data, raw, _, sources, _ = _vqofficial_form(tiny_config, "module")
    path = _import(tmp_path, data, raw)["path"]
    config = _write(tmp_path, "config.yml",
                    dict(data, trainer=dict(data["trainer"], log_dir=str(tmp_path / "zlog"))))
    resumed = cli.run(["--config", config, "--debug", "--device", "cpu"],
                      overrides={"architecture.vqdiffusion.resume_path": path})["worker"]
    assert resumed.global_step == STEP + 2
    counts = resumed.state.lt.Lt_count
    assert float(counts.sum()) == float(sources["lt"][1].sum()) + 4
    out = generate.run(["--config", config, "--device", "cpu", "--ckpt", path,
                        "--n-samples", "2", "--seed", "3"])
    want = worker_class("vqdiffusion")(t_config_from_dict(data), str(tmp_path / "w"), seed=3,
                                       device="cpu")
    want.init_state()
    want.state.ema.load_state_dict(sources["ema"], strict=True)
    indices = want.composite.sample(2, generator=torch.Generator().manual_seed(3),
                                    unet=want.state.ema)
    assert torch.equal(out["indices"], indices)

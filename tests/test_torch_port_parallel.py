"""The port's data parallelism (``vq_vae_gan_diffusion_torch/parallel``) over
gloo ranks spawned on the CPU, against the JAX package on its 8-device
virtual mesh and against the port's own single process on the global
batch.

One spawn of 2 ranks serves the module (``tests/torch_parallel_ranks.py``,
which imports no ``jax``): each family's worker at ``tiny_config`` sizes
takes 2 steps on the same two global batches, each rank its rows, while
this process runs the single-process steps and the JAX worker.

Tolerances:

- the VQGAN step over 2 ranks against the JAX worker over the 8-device mesh
  from the same transplanted weights: every metric within 1e-4 relative
  at the first step (as ``test_torch_port_vqgan.py`` holds one process
  against one device; the adaptive lambda, the touchiest, lies 7.7e-4
  (the port) and 8.3e-4 (JAX) from its float64 value there, 6.3e-5 from
  each other), within 1e-2 at the second (see below);
  parameters: every entry within 2 lr a step and 99% of all entries within
  lr / 10; the discriminator's running statistics within 1e-4;
- every family over 2 ranks against the single process on the whole batch:
  the first step's metrics within 1e-5 relative and its gradients within
  3e-4 of each live leaf's largest entry (of the step's largest for a leaf
  that is rounding, as ``test_torch_port_vqgan.py`` splits them: the
  ShuffleNet's convs ahead of a BatchNorm lie up to 1.3e-4 off, its
  variance taken over the ranks as flax takes it, ``E[x²] - mean²``); the
  gaussian3d prior again in float64, where both agree within 1e-10; the
  second step's metrics within 1e-2, since Adam's first step moves an
  entry whose gradient is rounding by about lr either way on each side (the
  stage-1 lambda of the second step moved by 3.4e-3 between two single
  processes); parameters and EMA copies by the same lr rule, BatchNorm
  statistics and VQ_Official's history within 1e-4 (as the JAX
  comparison's), its counts equal;
- the ranks against each other: every tensor of the state (parameters,
  optimizer moments, EMA, running statistics, history) and the generator
  equal, bit for bit, as the JAX test's ``_shard_consistent``.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from torch_parallel_ranks import cli_runs, families, spawn
from vq_vae_gan_diffusion_torch import generate, weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.parallel import (batch_rows, create_mesh, data_rows, draw_rows,
                                                 pad_to_multiple, shard_batch)
from vq_vae_gan_diffusion_tpu.parallel import pad_to_multiple as j_pad_to_multiple
from vq_vae_gan_diffusion_tpu.parallel import shard_batch as j_shard_batch
from vq_vae_gan_diffusion_tpu.train.vqgan_worker import VQGANVQVAEWorker as JaxWorker

STEPS, WORLD = 2, 2
VQGAN_BATCH, BATCH = 8, 4          # VQGAN's batch is the JAX mesh's 8 devices'
# after the first step: Adam moves each entry whose gradient is rounding by
# about lr either way on each side, and the second step starts there (the
# stage-1 lambda then moved by 3.4e-3 between two single processes on one
# machine under different thread settings)
LATER_REL = 1e-2
# the first step's gradients: the conv ahead of the ShuffleNet's first
# BatchNorm differs by 6e-5 of its largest entry between flax's E[x^2] -
# mean^2 over the ranks and the single process's two-pass variance
GRAD_REL = 3e-4
# the same ShuffleNet prior in float64: the ranks and the single process then
# agree to 6e-13 of each live leaf's largest gradient entry
F64_REL = 1e-10


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# -- the mesh helpers ----------------------------------------------------------------------

@pytest.mark.parametrize("size", [2, 4, 8])
def test_shard_batch_rows_are_jax_shards(size):
    """Data rank r of D holds the rows of JAX's r-th addressable shard of a
    batch sharded over a ('data', 'model') mesh of D x 1."""
    from vq_vae_gan_diffusion_tpu.parallel import create_mesh as j_create_mesh

    mesh = j_create_mesh(jax.devices()[:size])
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    shards = sorted(j_shard_batch(x, mesh).addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    for r, shard in enumerate(shards):
        np.testing.assert_array_equal(x[batch_rows(16, r, size)], np.asarray(shard.data))
    with pytest.raises(ValueError, match="not divisible"):
        batch_rows(6, 0, 4)


def test_helpers_without_a_group():
    """No process group: no mesh, the batch whole, draws of their own size,
    and ``pad_to_multiple`` as the JAX package's."""
    assert create_mesh() is None and create_mesh(3) is None
    x = torch.arange(10.0).reshape(5, 2)
    assert shard_batch(x, None) is x
    with data_rows(None):
        assert draw_rows(lambda n: torch.zeros(n), 3).shape == (3,)
    for b in (4, 5, 7):
        got, real = pad_to_multiple(np.arange(b * 2.0).reshape(b, 2), 4)
        want, jreal = j_pad_to_multiple(jnp.arange(b * 2.0).reshape(b, 2), 4)
        np.testing.assert_array_equal(got, np.asarray(want))
        tgot, _ = pad_to_multiple(torch.arange(b * 2.0).reshape(b, 2), 4)
        np.testing.assert_array_equal(tgot.numpy(), np.asarray(want))
        assert real == jreal == b


# -- the families over 2 ranks -------------------------------------------------------------

def _family_configs(tiny_config) -> dict:
    """Each family's config at tiny_config sizes (the U-Nets at base 8 or 16),
    as the port's single-family tests write them."""
    def model(name, **paths):
        cfg = tiny_config.replace_path("architecture.model_name", name)
        for path, value in paths.items():
            cfg = cfg.replace_path(path, value)
        return cfg.to_dict()
    vqo = tiny_config.to_dict()       # K 32 over N 16 (latent 4x4), the Conv1d U-Net
    vqo["architecture"]["model_name"] = "vqdiffusion"
    vqo["architecture"]["vqvae"].update({"num_codebook_vectors": 32, "latent_size": 4,
                                         "intermediate_channels": [16, 32, 32, 32]})
    vqo["architecture"]["vqdiffusion"].update({
        "diffusion_type": "VQ_Official", "diffusion_steps": 10, "sampling_steps": 3,
        "unet_dim": 2, "unet_base_dim": 8, "unet_dim_mults": [1, 2]})
    return {
        # LPIPS off: it is per image, so data parallelism leaves it as it is
        # (test_torch_port_vqgan.py holds it), and the JAX step compiles in
        # half the time without it
        "vqgan": model("vqgan", **{"trainer.descriminator.disc_start": 1,
                                   "trainer.vqvae.perceptual_loss_factor": 0.0}),
        "vqofficial": vqo,
        "vqofficial_warm": vqo,
        "gaussian3d_f64": model("vqdiffusion",
                                **{"architecture.vqdiffusion.unet_base_dim": 16,
                                   "architecture.vqdiffusion.unet_dim_mults": [1, 2]}),
        "gaussian3d": model("vqdiffusion", **{"architecture.vqdiffusion.unet_base_dim": 16,
                                              "architecture.vqdiffusion.unet_dim_mults": [1, 2]}),
        "pixel3d": model("gaussiandiffusion3d"),
        "gaussian2d": model("gaussiandiffusion2d",
                            **{"architecture.gaussiandiffusion2d.unet_base_dim": 8,
                               "architecture.gaussiandiffusion2d.unet_dim_mults": [1, 2]}),
        "vae": model("vae"),
        "c_vqdiffusion": model("c_vqdiffusion", **{"architecture.vqdiffusion.unet_base_dim": 8,
                                                   "architecture.vqdiffusion.unet_dim_mults":
                                                   [1, 2]}),
        "gpt": model("vqvae_transformer"),
    }


def _jax_vqgan(cfg, mesh, init_path: str):
    """The JAX worker on the mesh, its starting weights transplanted into
    ``init_path`` for the port; returns a function of the batches that runs
    its steps."""
    jw = JaxWorker(cfg, tempfile.mkdtemp(), mesh=mesh)
    js = jw.init_state()
    host = jax.device_get(js)
    tc = t_config_from_dict(cfg.to_dict())
    torch.save({"vqvae": W.vqvae_state_from_jax(host.vqvae_params, tc),
                "disc": W.discriminator_state_from_jax(host.disc_params, host.disc_batch_stats),
                "lpips": W.lpips_state_from_jax(jax.tree_util.tree_map(np.asarray,
                                                                       jw.lpips_params))},
               init_path + ".tmp")
    os.replace(init_path + ".tmp", init_path)      # the ranks wait for the whole file

    def steps(batches):
        jw.state = js
        jw.place_on_mesh()
        state, out = jw.state, []
        for b in batches:
            state, m = jw.train_step(state, j_shard_batch(b, mesh), jax.random.PRNGKey(0))
            out.append({k: float(v) for k, v in m.items()})
        return out, jax.device_get(state), tc
    return steps


@pytest.fixture(scope="module")
def runs(tiny_config, mesh, tmp_path_factory):
    """Every family over 2 ranks and in this process, on the same batches;
    the VQGAN also through the JAX worker on the 8-device mesh."""
    tmp = str(tmp_path_factory.mktemp("parallel"))
    cfgs = _family_configs(tiny_config)
    rs = np.random.RandomState(0)
    batches = {name: [rs.uniform(-1, 1, (VQGAN_BATCH if name == "vqgan" else BATCH, 32, 32, 3))
                      .astype(np.float32) for _ in range(STEPS)] for name in cfgs}
    init = os.path.join(tmp, "vqgan_init.pt")
    jobs = {name: {"cfg_dict": cfg, "batches": batches[name],
                   "init": init if name == "vqgan" else None,
                   "warm_lt": name == "vqofficial_warm", "float64": name.endswith("_f64")}
            for name, cfg in sorted(cfgs.items(), key=lambda kv: kv[0] == "vqgan")}
    wait = spawn(families, (jobs,), WORLD, tmp)      # the stage-1 job last: it waits for init
    jax_side = _jax_vqgan(tiny_config.__class__(cfgs["vqgan"]), mesh, init)(batches["vqgan"])
    single = families(jobs)
    return {"single": single, "ranks": wait(), "jax": jax_side, "cfgs": cfgs}


def live_leaves(grads: dict) -> set:
    """The leaves whose largest gradient entry is above 1e-5 of the step's
    largest; the rest are zero but for f32 rounding (as
    ``test_torch_port_vqgan.py`` splits them)."""
    top = max(float(g.abs().max()) for g in grads.values())
    return {k for k, g in grads.items() if float(g.abs().max()) > 1e-5 * top}


def _leaves(tree, prefix=""):
    """(path, tensor) of every tensor in a nested state tree."""
    if isinstance(tree, torch.Tensor):
        yield prefix, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{prefix}/{i}")


def test_create_mesh_refuses_what_does_not_divide(runs):
    """Over 2 ranks ``create_mesh(3)`` raises with the JAX package's
    message."""
    from vq_vae_gan_diffusion_tpu.parallel import create_mesh as j_create_mesh

    with pytest.raises(ValueError) as want:
        j_create_mesh(jax.devices()[:2], model_parallel=3)
    assert [r["_mesh_error"] for r in runs["ranks"]] == [str(want.value)] * 2


@pytest.mark.parametrize("route", ["python", "native"])
def test_loaders_shard_the_global_batches(tmp_path, route):
    """Under ``shard=(r, 2)`` each loader walks the same seeded global order:
    the same len() on both ranks, and each batch's rows, rank 0's then rank
    1's, are the unsharded loader's batch, augmentation included."""
    from vq_vae_gan_diffusion_torch.data.datasets import SyntheticDataset
    from vq_vae_gan_diffusion_torch.data.native_loader import (NativeDataLoader,
                                                               build_sample_store)
    from vq_vae_gan_diffusion_torch.data.pipeline import DataLoader
    from vq_vae_gan_diffusion_torch.data.transforms import Preprocessor

    ds = SyntheticDataset(40, 20, 3, seed=3)
    if route == "python":
        def make(shard=(0, 1)):
            return DataLoader(ds, 8, Preprocessor(16, (0.5,) * 3, (0.5,) * 3, augment=True),
                              seed=5, num_threads=2, shard=shard)
    else:
        store = build_sample_store(ds, str(tmp_path / "s.sdb"), img_size=16)

        def make(shard=(0, 1)):
            return NativeDataLoader(store, 8, mean=(0.5,) * 3, std=(0.5,) * 3, p_hflip=0.5,
                                    p_rot=0.5, max_deg=20.0, seed=5, num_threads=2, shard=shard)
    whole, parts = make(), [make((r, 2)) for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 5
    for _ in range(2):                          # two epochs: the order moves on alike
        got = [list(p) for p in parts]
        want = list(whole)
        assert len(want) == len(got[0]) == len(got[1]) == 5
        for w, a, b in zip(want, *got):
            assert a.shape[0] == b.shape[0] == 4
            np.testing.assert_array_equal(np.concatenate([a, b]), w)


FAMILIES = ["vqgan", "vqofficial", "vqofficial_warm", "gaussian3d", "gaussian3d_f64",
            "pixel3d", "gaussian2d", "vae", "c_vqdiffusion", "gpt"]


@pytest.mark.parametrize("family", FAMILIES)
def test_ranks_hold_the_same_state(runs, family):
    """Every tensor of the state (parameters, optimizer state, EMA, running
    statistics, LtState) and the generator equal on both ranks."""
    a, b = (r[family] for r in runs["ranks"])
    la, lb = dict(_leaves(a["after"])), dict(_leaves(b["after"]))
    assert la.keys() == lb.keys() and la
    for k in la:
        assert torch.equal(la[k], lb[k]), k
    assert torch.equal(a["generator"], b["generator"])
    assert a["metrics"] == b["metrics"]


def _lr(cfg: dict) -> float:
    tr, model = cfg["trainer"], cfg["architecture"]["model_name"]
    key = {"vqgan": "vqvae", "vqdiffusion": "vqdiffusion", "vqvae_transformer":
           "vqvae_transformer", "c_vqdiffusion": "vqdiffusion"}.get(model, model)
    return float(tr[key].get("learning_rate", 1e-4))


@pytest.mark.parametrize("family", FAMILIES)
def test_two_ranks_match_one_process_on_the_global_batch(runs, family):
    """The steps over 2 ranks against the single process on the whole batch:
    metrics, the last step's gradients, parameters, EMA, running statistics
    and VQ_Official's history."""
    got, want = runs["ranks"][0][family], runs["single"][family]
    for i, (gm, wm) in enumerate(zip(got["metrics"], want["metrics"])):
        assert gm.keys() == wm.keys()
        for k in wm:
            rel = LATER_REL if i else F64_REL if family.endswith("_f64") else 1e-5
            assert gm[k] == pytest.approx(wm[k], rel=rel, abs=1e-7), (i, k, gm[k], wm[k])
    grads, want_grads = got["grads"][0], want["grads"][0]
    assert grads.keys() == want_grads.keys() and want_grads
    live = live_leaves(want_grads)
    top = max(float(g.abs().max()) for g in want_grads.values())
    for k, g in want_grads.items():
        scale = float(g.abs().max()) if k in live else top
        err = float((grads[k] - g).abs().max())
        assert err <= (F64_REL if family.endswith("_f64") else GRAD_REL) * scale, (k, err, scale)
    lr = _lr(runs["cfgs"][family])
    gl, wl = dict(_leaves(got["after"])), dict(_leaves(want["after"]))
    assert gl.keys() == wl.keys()
    near, total = 0, 0
    for k, w in wl.items():
        if any(part.startswith("opt") for part in k.split("/")):  # moved with their params
            continue
        if not w.is_floating_point() or "Lt_count" in k:
            assert torch.equal(gl[k], w), k
        elif "running" in k or "/lt/" in k:
            assert torch.allclose(gl[k], w, rtol=1e-4, atol=1e-4), (k, (gl[k] - w).abs().max())
        else:
            diff = (gl[k].double() - w.double()).abs()
            assert float(diff.max()) <= 2 * lr * STEPS + 1e-6, (k, float(diff.max()))
            near, total = near + int((diff <= lr / 10).sum()), total + diff.numel()
    assert total and near >= 0.99 * total, near / max(total, 1)


@pytest.mark.parametrize("family", ["vqofficial", "vqofficial_warm"])
def test_vqofficial_history_counts_the_global_batch(runs, family):
    """Each step scatters one count per row of the global batch, as the JAX
    step over the mesh does; the warm start draws t by importance."""
    for r in runs["ranks"]:
        before, after = r[family]["before"]["lt"], r[family]["after"]["lt"]
        assert float(after["Lt_count"].sum() - before["Lt_count"].sum()) == STEPS * BATCH
        assert float(after["Lt_history"].sum()) > 0


def test_vqgan_over_two_ranks_matches_the_jax_mesh(runs):
    """The VQGAN step over 2 gloo ranks against the JAX worker over the
    8-device mesh, from the same transplanted weights: metrics, parameters
    and the discriminator's running statistics."""
    jax_metrics, js, tc = runs["jax"]
    got = runs["ranks"][0]["vqgan"]
    for i, (gm, jm) in enumerate(zip(got["metrics"], jax_metrics)):
        for k in jm:
            rel = LATER_REL if i else 1e-4
            assert gm[k] == pytest.approx(jm[k], rel=rel, abs=1e-6), (i, k, gm[k], jm[k])
    lr = _lr(runs["cfgs"]["vqgan"])
    assert lr == 2.25e-4
    want = {f"vqvae.{k}": torch.as_tensor(np.asarray(v))
            for k, v in W.vqvae_state_from_jax(js.vqvae_params, tc).items()}
    disc = W.discriminator_state_from_jax(js.disc_params, js.disc_batch_stats)
    want.update({f"disc.{k}": torch.as_tensor(np.asarray(v)) for k, v in disc.items()
                 if "num_batches" not in k})
    after = got["after"]
    have = {f"vqvae.{k}": v for k, v in after["vqvae"].items()}
    have.update({f"disc.{k}": v for k, v in after["disc"].items() if "num_batches" not in k})
    stats = [k for k in want if "running" in k]
    for k in stats:
        assert torch.allclose(have[k], want[k], atol=1e-4), k
    near, total = 0, 0
    for k, w in want.items():
        if k in stats:
            continue
        diff = (have[k].double() - w.double()).abs()
        assert float(diff.max()) <= 2 * lr * STEPS + 1e-6, (k, float(diff.max()))
        near, total = near + int((diff <= lr / 10).sum()), total + diff.numel()
    assert near >= 0.99 * total, near / total


# -- the CLI over 2 ranks ------------------------------------------------------------------

def test_train_cli_over_two_ranks(tmp_path, tiny_config):
    """``--debug`` over 2 gloo ranks: the batch is max(2, 2 data ranks), one
    run dir on both ranks with one ``metrics.jsonl`` and one checkpoint;
    resumed, both ranks go on at step 3 from equal weights; the single
    process's ``generate`` reads the checkpoint."""
    data = tiny_config.replace_path("architecture.model_name", "vqgan") \
        .replace_path("trainer.log_dir", str(tmp_path / "zlog")).to_dict()
    config = tmp_path / "tiny_vqgan.yml"
    config.write_text(yaml.safe_dump(data))
    first, second = zip(*[(r["first"], r["second"]) for r in
                          spawn(cli_runs, (str(config),), WORLD, str(tmp_path))()])
    for runs in (first, second):
        assert runs[0]["run_dir"] == runs[1]["run_dir"]
        assert runs[0]["batch"] == runs[1]["batch"] == 2
        assert runs[0]["metrics"] == runs[1]["metrics"]
        for k, v in runs[0]["vqvae"].items():
            assert torch.equal(v, runs[1]["vqvae"][k]), k
    assert first[0]["step"] == 2 and second[0]["step"] == 4
    run_dirs = os.listdir(tmp_path / "zlog" / "synthetic" / "vqgan")
    assert len(run_dirs) == 2
    for run_dir, last in ((first[0]["run_dir"], 2), (second[0]["run_dir"], 4)):
        with open(os.path.join(run_dir, "metrics.jsonl")) as f:
            rows = [yaml.safe_load(line) for line in f]
        assert [r["step"] for r in rows] == [last - 1, last, last]
        assert os.listdir(os.path.join(run_dir, "ckpt")) == [f"step_{last:08d}.pth"]
    ckpt = os.path.join(second[0]["run_dir"], "ckpt", "step_00000004.pth")
    saved = torch.load(ckpt, weights_only=True)
    assert saved["step"] == 4 and saved["state"]["step"] == 4
    assert all(torch.equal(saved["state"]["vqvae"][k], v) for k, v in second[0]["vqvae"].items())
    out = generate.run(["--config", str(config), "--device", "cpu", "--ckpt", ckpt,
                        "--n-samples", "2"])
    assert tuple(out["images"].shape) == (2, 32, 32, 3)

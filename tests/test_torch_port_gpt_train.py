"""The port's GPT prior training (``vqvae_transformer``) against the JAX
package's ``VQTransformerWorker``, and its CLI on the CPU.

Geometry: tests/conftest.py::tiny_config (latent 8 -> 64 tokens, vocab 64,
GPT C=32, L=2, H=4, 32x32x3 images, batch 4). The port takes the JAX
worker's weights transplanted, and JAX's corruption draws (the bernoulli
keep mask and the replacement indices of ``VQTransformer.forward``) are
computed from the step's key and handed in.

Tolerances:

- training logits within 1e-4; targets identical; remat against no remat
  within 1e-6 (the same ops recomputed);
- one step: ``ce_loss`` and ``token_accuracy`` within 1e-5 relative;
  gradients leaf by leaf within 1e-5 of the leaf's largest JAX entry, and
  a leaf whose JAX gradient is below ROUNDING (1e-5) of the step's largest
  within 1e-5 of the step's largest (the attention key biases: softmax
  ignores a shift common to a row's scores, so their gradient is zero but
  for f32 rounding);
- parameters after 3 steps as tests/test_torch_port_vqgan.py holds them:
  every entry within 2 lr a step, and in each live leaf 99% within lr / 10
  (Adam moves each entry by about lr whatever its gradient's size);
- the reconstruction row of ``log_images`` within 1e-4.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import yaml

from vq_vae_gan_diffusion_torch import generate
from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.config import config_from_dict as t_config_from_dict
from vq_vae_gan_diffusion_torch.models.mingpt import GPT as TorchGPT
from vq_vae_gan_diffusion_torch.train import cli
from vq_vae_gan_diffusion_torch.train.base import MultiSteps
from vq_vae_gan_diffusion_torch.train.vq_transformer_worker import VQTransformerWorker as TorchWorker
from vq_vae_gan_diffusion_torch.train.vq_transformer_worker import decay_names
from vq_vae_gan_diffusion_tpu.train.vq_transformer_worker import VQTransformerWorker as JaxWorker
from vq_vae_gan_diffusion_tpu.train.vq_transformer_worker import mingpt_decay_mask

STEPS, BATCH = 3, 4
GRAD_TOL, ROUNDING = 1e-5, 1e-5


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    """Two intra-op threads: at these sizes torch gains nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _config(tiny_config, **paths):
    cfg = tiny_config.replace_path("architecture.model_name", "vqvae_transformer")
    for path, value in paths.items():
        cfg = cfg.replace_path(path, value)
    return cfg


def port_worker(jax_worker, cfg, state) -> TorchWorker:
    """A port worker on the CPU carrying the JAX worker's VQVAE and GPT
    weights, with a fresh optimizer."""
    tc = t_config_from_dict(cfg.to_dict())
    tw = TorchWorker(tc, tempfile.mkdtemp(), device="cpu")
    tw.state = tw.init_state()
    state = jax.device_get(state)
    tw.composite.vqvae.load_state_dict(W.vqvae_state_from_jax(state.vq_params, tc), strict=True)
    tw.composite.gpt.load_state_dict(W.gpt_state_from_jax(state.gpt_params), strict=True)
    return tw


def jax_draws(jax_worker, imgs, rng):
    """The keep mask and replacement indices the JAX forward draws from ``rng``."""
    b, t = imgs.shape[0], jax_worker.composite.seq_len
    vocab, pkeep = jax_worker.composite.vocab_size, jax_worker.composite.pkeep
    rng_mask, rng_rand, _ = jax.random.split(rng, 3)
    keep = jax.random.bernoulli(rng_mask, pkeep, (b, t)).astype(jnp.int32)
    rand = jax.random.randint(rng_rand, (b, t), 0, vocab, jnp.int32)
    return torch.from_numpy(np.asarray(keep)).long(), torch.from_numpy(np.asarray(rand)).long()


def _jax_loss(jax_worker):
    composite = jax_worker.composite

    def loss_fn(gpt_params, vq_params, imgs, rng):
        logits, targets = composite.forward(gpt_params, vq_params, imgs, rng)
        return optax.softmax_cross_entropy_with_integer_labels(
            logits.reshape(-1, logits.shape[-1]).astype(jnp.float32), targets.reshape(-1)).mean()
    return loss_fn


def live_leaves(grads: dict) -> set:
    top = max(float(g.abs().max()) for g in grads.values())
    return {k for k, g in grads.items() if float(g.abs().max()) > ROUNDING * top}


def assert_params_close(got: dict, want: dict, steps: int, live: set, lr: float) -> None:
    diffs = {k: (got[k].double() - want[k].double()).abs() for k in want if "mask" not in k}
    worst = max(diffs, key=lambda k: diffs[k].max())
    assert diffs[worst].max() <= 2 * lr * steps + 1e-6, worst
    for k in live:
        near = (diffs[k] <= lr / 10).double().mean()
        assert near >= 0.99, f"{k}: {100 * float(near):.2f}% within lr / 10"


@pytest.fixture(scope="module")
def runs(tiny_config):
    """Both workers through the same three steps (JAX keys 0, 1, 2): each
    step's metrics and GPT parameters; the first step's gradients on both
    sides; the first batch's logits and targets from the starting weights."""
    cfg = _config(tiny_config)
    jw = JaxWorker(cfg, tempfile.mkdtemp())
    js = jw.init_state()
    tw = port_worker(jw, cfg, js)
    ts = tw.state
    rs = np.random.RandomState(0)
    batches = [rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32) for _ in range(STEPS)]
    keys = [jax.random.PRNGKey(i) for i in range(STEPS)]
    out = {"cfg": t_config_from_dict(cfg.to_dict()), "jax": [], "port": [],
           "lr": float(cfg.trainer.vqvae_transformer.learning_rate)}
    fwd = jax.jit(jw.composite.forward)
    logits, targets = fwd(js.gpt_params, js.vq_params, jnp.asarray(batches[0]), keys[0])
    keep, rand = jax_draws(jw, batches[0], keys[0])
    with torch.no_grad():
        t_logits, t_targets = tw.composite(torch.from_numpy(batches[0]), keep=keep,
                                           random_indices=rand)
    out["forward"] = (np.asarray(logits), np.asarray(targets), t_logits.numpy(),
                      t_targets.numpy())
    grad = jax.jit(jax.grad(_jax_loss(jw)))(js.gpt_params, js.vq_params,
                                            jnp.asarray(batches[0]), keys[0])
    out["jax_grads"] = W.gpt_state_from_jax(jax.device_get(grad))
    for i, (b, key) in enumerate(zip(batches, keys)):
        js, jm = jw.train_step(js, jnp.asarray(b), key)
        out["jax"].append(({k: float(v) for k, v in jm.items()},
                           W.gpt_state_from_jax(jax.device_get(js.gpt_params))))
        keep, rand = jax_draws(jw, b, key)
        ts, tm = tw.train_step(ts, torch.from_numpy(b), keep=keep, random_indices=rand)
        if i == 0:
            out["port_grads"] = {k: p.grad.clone() for k, p in ts.gpt.named_parameters()}
        out["port"].append(({k: float(v) for k, v in tm.items()},
                            {k: v.clone() for k, v in ts.gpt.state_dict().items()}))
    out["live"] = live_leaves({k: v for k, v in out["jax_grads"].items() if "mask" not in k})
    out["jax_worker"], out["jax_state"], out["port_worker"] = jw, js, tw
    return out


def test_training_logits_and_targets_match_jax(runs):
    want_logits, want_targets, got_logits, got_targets = runs["forward"]
    np.testing.assert_array_equal(got_targets, want_targets)
    np.testing.assert_allclose(got_logits, want_logits, rtol=1e-4, atol=1e-4)


def test_one_step_loss_and_gradients_match_jax(runs):
    """The first step's metrics within 1e-5 relative and its gradients leaf
    by leaf within 1e-5 of the leaf's largest JAX entry."""
    (jm, _), (tm, _) = runs["jax"][0], runs["port"][0]
    assert set(tm) == set(jm) == {"ce_loss", "token_accuracy"}
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=k)
    want = {k: v for k, v in runs["jax_grads"].items() if "mask" not in k}
    got = runs["port_grads"]
    assert set(got) == set(want)
    top = max(float(g.abs().max()) for g in want.values())
    rounding = set(want) - runs["live"]
    assert rounding <= {k for k in want if k.endswith("attn.key.bias")}
    for k, g in want.items():
        scale = float(g.abs().max()) if k in runs["live"] else top
        err = float((got[k].double() - g.double()).abs().max())
        assert err <= GRAD_TOL * scale, f"{k}: {err:.3e} against {scale:.3e}"


def test_trajectory_matches_jax(runs):
    """Three steps: metrics within 1e-5 relative and GPT parameters after
    every step."""
    for i in range(STEPS):
        (jm, jp), (tm, tp) = runs["jax"][i], runs["port"][i]
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, err_msg=f"step {i} {k}")
        assert_params_close(tp, jp, i + 1, runs["live"], runs["lr"])
    assert runs["port_worker"].state.step == STEPS


def test_decay_set_equals_mingpt_decay_mask(runs):
    """The parameters AdamW decays are the leaves mingpt_decay_mask marks,
    under the weights.py name map; the head's kernel is one of them."""
    params = jax.device_get(runs["jax_state"].gpt_params)
    mask = mingpt_decay_mask(params)
    ones = jax.tree_util.tree_map(lambda m, p: np.full(np.shape(p), float(m), np.float32),
                                  mask, params)
    marked = {k for k, v in W.gpt_state_from_jax(ones).items()
              if "mask" not in k and bool((v == 1).all())}
    gpt = runs["port_worker"].composite.gpt
    assert set(decay_names(gpt)) == marked
    assert "head.weight" in marked and "tok_emb.weight" not in marked
    opt = runs["port_worker"].state.opt
    groups = {g["weight_decay"]: {id(p) for p in g["params"]} for g in opt.param_groups}
    named = dict(gpt.named_parameters())
    assert groups[0.01] == {id(named[k]) for k in marked}
    assert groups[0.0] == {id(p) for k, p in named.items() if k not in marked}


def test_remat_equals_no_remat():
    """architecture.<model>.remat checkpoints each block: the same logits and
    gradients within 1e-6."""
    idx = torch.from_numpy(np.random.RandomState(1).randint(0, 64, (2, 20)))
    out = []
    for remat in (False, True):
        gpt = TorchGPT(vocab_size=64, block_size=32, n_layer=2, n_head=4, n_embd=32, remat=remat)
        gpt.init_weights(torch.Generator().manual_seed(0))
        logits = gpt(idx)
        logits.square().mean().backward()
        out.append((logits.detach(), {k: p.grad for k, p in gpt.named_parameters()}))
    (l0, g0), (l1, g1) = out
    torch.testing.assert_close(l1, l0, rtol=0, atol=1e-6)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-6, msg=k)


def test_accumulation_matches_jax(tiny_config):
    """gradient_accumulate_every 2: nothing moves on the first step on either
    side, both apply the mean gradient on the second."""
    cfg = _config(tiny_config, **{"trainer.vqvae_transformer.gradient_accumulate_every": 2})
    jw = JaxWorker(cfg, tempfile.mkdtemp())
    js = jw.init_state()
    tw = port_worker(jw, cfg, js)
    ts = tw.state
    assert isinstance(ts.opt, MultiSteps)
    start = {k: v.clone() for k, v in ts.gpt.state_dict().items()}
    rs = np.random.RandomState(4)
    lr = float(cfg.trainer.vqvae_transformer.learning_rate)
    for i in range(2):
        b, key = rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32), jax.random.PRNGKey(i)
        if i == 0:
            grad = jax.jit(jax.grad(_jax_loss(jw)))(js.gpt_params, js.vq_params, jnp.asarray(b),
                                                    key)
            live = live_leaves({k: v for k, v in W.gpt_state_from_jax(
                jax.device_get(grad)).items() if "mask" not in k})
        js, jm = jw.train_step(js, jnp.asarray(b), key)
        keep, rand = jax_draws(jw, b, key)
        ts, tm = tw.train_step(ts, torch.from_numpy(b), keep=keep, random_indices=rand)
        for k in jm:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5, err_msg=k)
        if i == 0:
            assert all(torch.equal(v, start[k]) for k, v in ts.gpt.state_dict().items())
            assert ts.opt.mini_step == 1
    assert ts.opt.mini_step == 0
    assert_params_close(ts.gpt.state_dict(), W.gpt_state_from_jax(jax.device_get(js.gpt_params)),
                        1, live, lr)


def test_log_images_rows(runs):
    """Four rows of NHWC images; the reconstruction equals the JAX
    composite's within 1e-4; the GPT samples in eval mode and is back in
    train mode after."""
    jw, js, tw = runs["jax_worker"], runs["jax_state"], runs["port_worker"]
    x = np.random.RandomState(5).uniform(-1, 1, (2, 32, 32, 3)).astype(np.float32)
    tw.composite.gpt.train()
    logs = tw.composite.log_images(torch.from_numpy(x), torch.Generator().manual_seed(0))
    assert set(logs) == {"input", "rec", "half_sample", "full_sample"}
    for k, v in logs.items():
        assert tuple(v.shape) == (2, 32, 32, 3) and torch.isfinite(v).all(), k
    assert tw.composite.gpt.training
    rec = jax.jit(lambda vq, x: jw.composite.z_to_image(vq, jw.composite.encode_to_z(vq, x)[1]))
    want = rec(js.vq_params, jnp.asarray(x))
    np.testing.assert_allclose(logs["rec"].numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)


# -- the CLI on the CPU ------------------------------------------------------------

def _write(tmp_path, name: str, data: dict) -> str:
    path = tmp_path / name
    path.write_text(yaml.safe_dump(data))
    return str(path)


def stage1_checkpoint(tmp_path, tiny_config) -> str:
    """A stage-1 checkpoint of the port: ``train --debug`` of the tiny vqgan."""
    data = tiny_config.replace_path("architecture.model_name", "vqgan") \
        .replace_path("trainer.log_dir", str(tmp_path / "zlog")).to_dict()
    out = cli.run(["--config", _write(tmp_path, "stage1.yml", data), "--debug",
                   "--device", "cpu"])
    return os.path.join(out["run_dir"], "ckpt", "step_00000002.pth")


def _rows(run_dir):
    import json
    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_train_cli_debug_resume_and_generate(tmp_path, tiny_config):
    """--debug on the CPU over a stage-1 checkpoint: two steps, metrics.jsonl,
    a checkpoint holding the frozen VQVAE as trained in stage 1, the
    four-row grid and the epoch's samples. Resuming from the GPT checkpoint
    goes on at step 3; ``generate --ckpt`` on it serves the trained GPT."""
    stage1 = stage1_checkpoint(tmp_path, tiny_config)
    data = _config(tiny_config, **{"trainer.log_dir": str(tmp_path / "zlog"),
                                   "architecture.vqvae.resume_path": stage1}).to_dict()
    config = _write(tmp_path, "gpt.yml", data)
    first = cli.run(["--config", config, "--debug", "--device", "cpu"])
    rows = _rows(first["run_dir"])
    assert [r["step"] for r in rows] == [1, 2, 2]
    assert all({"ce_loss", "token_accuracy"} <= set(r) for r in rows[:2])
    for name in ("transformer_epoch0_0.jpg", "samples_epoch0.jpg", "info.log"):
        assert os.path.exists(os.path.join(first["run_dir"], name)), name
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    tree = torch.load(ckpt, weights_only=True)
    assert tree["step"] == 2 and tree["state"]["step"] == 2
    assert {"vqvae", "gpt", "opt"} <= set(tree["state"])
    frozen = torch.load(stage1, weights_only=True)["state"]["vqvae"]
    assert all(torch.equal(tree["state"]["vqvae"][k], v) for k, v in frozen.items())

    second = cli.run(["--config", config, "--debug", "--device", "cpu"],
                     overrides={"architecture.vqvae_transformer.resume_path": ckpt})
    assert second["worker"].global_step == 4 and second["worker"].state.step == 4
    assert [r["step"] for r in _rows(second["run_dir"])] == [3, 4, 4]

    out = generate.run(["--config", config, "--device", "cpu", "--ckpt", ckpt,
                        "--n-samples", "2", "--seed", "3"])
    want = TorchWorker(t_config_from_dict(data), str(tmp_path), seed=3, device="cpu")
    want.init_state()
    want.composite.gpt.load_state_dict(tree["state"]["gpt"], strict=True)
    ref = want.generate_images(n_samples=2)
    assert torch.equal(out["tokens"], ref["tokens"])
    assert torch.equal(out["images"], ref["images"])


def test_train_cli_refuses_without_gpu(tmp_path, tiny_config, monkeypatch):
    """No GPU and no --device cpu: the GPT's training raises."""
    data = _config(tiny_config, **{"trainer.log_dir": str(tmp_path / "zlog")}).to_dict()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.run(["--config", _write(tmp_path, "gpt.yml", data), "--debug"])

"""The GPT prior's pipeline parallelism (``parallel/pipeline.py``) and
sequence parallelism (``GPT(act_sharding=...)``, ``parallel/sequence.py``)
over gloo ranks spawned on the CPU, against the JAX package's
``parallel/pipeline.py`` and ``act_sharding`` on its 8-device virtual mesh
and against the port's plain GPT in this process.

The GPT is the JAX test's (``tests/test_pipeline_sp.py``): vocab 32, block
16, 4 layers, 2 heads, width 16, its weights drawn by flax and carried
through ``weights.gpt_state_from_jax``; ``idx`` and the targets [8, 8].
One spawn of 2 ranks runs a pipe of 2 stages (n_micro 2, 3 Adam steps) and
sequence parallelism on a 1 x 2 mesh; one of 4 ranks runs pipes of 4
stages (n_micro 4, the JAX step's, and n_micro 2), 2 stages x 2 data ranks
(3 steps) and sequence parallelism on 2 x 2, with replicated parameters and
with ``param_sharding: tp`` (Megatron-SP); the spawns also build the GPT
worker under tp, fsdp and tp_fsdp for its optimizer's setting. Each spawn
is waited for at most 120 s, so a hang fails its tests.

Tolerances:

- stacking: equal element for element to JAX's stacked leaves, through
  ``weights.py``'s names and the kernel's transpose;
- pipelined logits within 1e-5 of JAX's ``pipelined_gpt_logits`` and of
  the port's plain forward (the JAX test's atol);
- one pipelined step: the loss within 1e-6 relative of JAX's
  ``make_pipeline_train_step``; every gradient, before the optimizer,
  within 1e-5 of the plain GPT's, scaled by the leaf's largest entry. The
  key bias's gradient is zero in exact arithmetic (a key bias shifts a
  row's scores alike) and rounding on both sides, so it is held against
  its block's largest gradient entry. A factor of S or of the data size in
  any leaf fails. The updated stage within 5e-5 of JAX's update (the JAX
  test's atol: Adam's first step is sign-like on rounding gradients);
- a 3-step trajectory against the single process by the trajectory rule
  (every parameter within 2 lr a step, 99% within lr / 10), the losses
  within 1e-5 relative;
- sequence parallelism: logits within 1e-5 and gradients within 2e-5 of
  JAX's ``act_sharding`` forward and ``jax.grad`` (the JAX test's
  tolerances), the key bias by the block rule above;
- the pipeline-trained GPT, unstacked, samples the single process's tokens
  at temperature 1e-4, every one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

from torch_parallel_ranks import pipeline_runs, spawn
from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.models.mingpt import GPT, sample_tokens
from vq_vae_gan_diffusion_torch.parallel import (pipelined_gpt_logits, shard_stacked,
                                                 stack_block_params, unstack_block_params)
from vq_vae_gan_diffusion_tpu.models.mingpt import GPT as JaxGPT
from vq_vae_gan_diffusion_tpu.parallel import DATA_AXIS, MODEL_AXIS
from vq_vae_gan_diffusion_tpu.parallel import create_mesh as j_create_mesh
from vq_vae_gan_diffusion_tpu.parallel import create_pipeline_mesh as j_pipeline_mesh
from vq_vae_gan_diffusion_tpu.parallel import make_pipeline_train_step as j_train_step
from vq_vae_gan_diffusion_tpu.parallel import pipelined_gpt_logits as j_pipelined_logits
from vq_vae_gan_diffusion_tpu.parallel import shard_batch as j_shard_batch
from vq_vae_gan_diffusion_tpu.parallel import shard_stacked as j_shard_stacked
from vq_vae_gan_diffusion_tpu.parallel import stack_block_params as j_stack
from vq_vae_gan_diffusion_tpu.parallel import unstack_block_params as j_unstack

GPT_KW = dict(vocab_size=32, block_size=16, n_layer=4, n_head=2, n_embd=16)
LR, STEPS = 1e-2, 3
TWO = {"pipe2": {"stages": 2, "n_micro": 2}, "sp1x2": {"mp": 2}}
FOUR = {"pipe4": {"stages": 4, "n_micro": 4}, "pipe4_m2": {"stages": 4, "n_micro": 2, "steps": 1},
        "pipe2x2": {"stages": 2, "n_micro": 2}, "sp2x2": {"mp": 2},
        "tp_sp2x2": {"mp": 2, "tp": True}}


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _ce(logits, targets):
    return jnp.mean(-jax.nn.log_softmax(logits)[
        jnp.arange(targets.shape[0])[:, None], jnp.arange(targets.shape[1])[None, :], targets])


def _jax_sp(gpt_params, idx, tgt, n_devices: int):
    """JAX's act_sharding GPT on a (n / 2) x 2 mesh: logits and gradients."""
    mesh = j_create_mesh(jax.devices()[:n_devices], model_parallel=2)
    sp = JaxGPT(**GPT_KW, act_sharding=jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(DATA_AXIS, MODEL_AXIS, None)))

    def loss(p):
        lg = sp.apply({"params": p}, j_shard_batch(idx, mesh))
        return _ce(lg, tgt), lg
    (_, logits), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
        jax.device_put(gpt_params, jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec())))
    return np.asarray(logits), W.gpt_state_from_jax(jax.device_get(grads))


def _worker_jobs(tiny_config, modes) -> dict:
    """The GPT worker (tiny_config's prior at width 64) under each
    (param_sharding, mp) of ``modes``, by name."""
    cfg = tiny_config.replace_path("architecture.model_name", "vqvae_transformer") \
        .replace_path("architecture.vqvae_transformer.n_embd", 64).to_dict()
    return {f"worker_{name}": {"cfg_dict": cfg, "param_sharding": mode, "mp": mp}
            for name, (mode, mp) in modes.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory, tiny_config):
    """The ranks' runs, JAX's references and the port's single process, on
    the JAX test's GPT and batches."""
    tmp = str(tmp_path_factory.mktemp("pipeline"))
    jgpt = JaxGPT(**GPT_KW)
    idx = jax.random.randint(jax.random.PRNGKey(1), (8, 8), 0, 32)
    tgt = jax.random.randint(jax.random.PRNGKey(2), (8, 8), 0, 32)
    params = jgpt.init(jax.random.PRNGKey(0), idx)["params"]
    state = W.gpt_state_from_jax(jax.device_get(params))
    rs = np.random.RandomState(3)
    batches = [(np.array(idx), np.array(tgt))] + [
        (rs.randint(0, 32, (8, 8)), rs.randint(0, 32, (8, 8))) for _ in range(STEPS - 1)]
    batches = [(torch.from_numpy(i).long(), torch.from_numpy(t).long()) for i, t in batches]
    four = {**FOUR, **_worker_jobs(tiny_config, {"tp_2x2": ("tp", 2), "fsdp": ("fsdp", 1),
                                                 "tp_fsdp": ("tp_fsdp", 2)})}
    two = {**TWO, **_worker_jobs(tiny_config, {"tp": ("tp", 2)})}
    wait4 = spawn(pipeline_runs, (state, GPT_KW, batches, four, LR), 4, tmp)
    wait2 = spawn(pipeline_runs, (state, GPT_KW, batches, two, LR), 2, tmp)

    jax_out = {"logits": {}}
    for s, m in [(4, 4), (2, 2), (4, 2)]:
        mesh = j_pipeline_mesh(s, jax.devices()[:4])
        stacked, rest = j_stack(params, GPT_KW["n_layer"], s)
        jax_out["logits"][s, m] = np.asarray(jax.jit(
            lambda st, r, i, mesh=mesh, m=m: j_pipelined_logits(jgpt, st, r, i, mesh, m))(
                j_shard_stacked(stacked, mesh), rest, j_shard_batch(np.asarray(idx), mesh)))
    mesh = j_pipeline_mesh(4, jax.devices()[:4])
    stacked, rest = j_stack(params, GPT_KW["n_layer"], 4)
    opt = optax.adam(LR)
    pp = (j_shard_stacked(stacked, mesh), rest)
    pp2, _, loss = j_train_step(jgpt, opt, mesh, n_micro=4)(
        pp, opt.init(pp), j_shard_batch(np.asarray(idx), mesh), j_shard_batch(np.asarray(tgt), mesh))
    jax_out["loss"] = float(loss)
    jax_out["updated"] = W.gpt_state_from_jax(jax.device_get(j_unstack(pp2[0], pp2[1])))
    jax_out["sp"] = {n: _jax_sp(params, idx, tgt, n) for n in (2, 4)}

    # the port's plain GPT: logits, the first step's gradients, 3 Adam steps
    gpt = GPT(**GPT_KW)
    gpt.load_state_dict(state)
    opt = torch.optim.Adam(gpt.parameters(), lr=LR)
    plain = {"logits": gpt(batches[0][0]).detach(), "losses": []}
    for i, (b_idx, b_tgt) in enumerate(batches):
        opt.zero_grad()
        loss = F.cross_entropy(gpt(b_idx).reshape(-1, 32), b_tgt.reshape(-1))
        loss.backward()
        if i == 0:
            plain["grads"] = {k: p.grad.clone() for k, p in gpt.named_parameters()}
        opt.step()
        plain["losses"].append(loss.item())
    plain["state"] = {k: v.clone() for k, v in gpt.state_dict().items()}
    ranks = {}
    for res in (wait4(timeout=120), wait2(timeout=120)):
        for name in res[0]:
            ranks[name] = [r[name] for r in res]
    return {"state": state, "params": params, "batches": batches, "jax": jax_out,
            "plain": plain, "ranks": ranks}


def _block_scale(grads: dict, name: str) -> float:
    """The largest gradient entry of the block that holds ``name``."""
    block = name.rsplit(".attn.", 1)[0] + "."
    return max(float(g.abs().max()) for k, g in grads.items() if k.startswith(block))


def _check_grads(got: dict, want: dict, rel: float) -> None:
    """Each leaf of ``got`` within ``rel`` of ``want``'s largest entry (the
    key bias: of its block's largest gradient entry)."""
    for k, g in got.items():
        w = want[k]
        scale = _block_scale(want, k) if k.endswith("attn.key.bias") else float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= rel * scale, (k, err, scale)


def _stage_names(r: dict) -> dict:
    """A rank's stage leaf ``stage.{j}.<leaf>`` -> the GPT's ``blocks.{i}.<leaf>``."""
    stage, s = r["stage"]
    per = GPT_KW["n_layer"] // s

    def name(k: str) -> str:
        j, leaf = k.split(".", 2)[1:]
        return f"blocks.{stage * per + int(j)}.{leaf}"
    return name


# -- stacking -------------------------------------------------------------------------------

@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_stack_is_jax_stack_and_round_trips(runs, n_stages):
    state, params = runs["state"], runs["params"]
    stacked, rest = stack_block_params(state, GPT_KW["n_layer"], n_stages)
    back = unstack_block_params(stacked, rest)
    assert back.keys() == state.keys()
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    j_stacked, j_rest = j_stack(params, GPT_KW["n_layer"], n_stages)
    per = GPT_KW["n_layer"] // n_stages
    for s in range(n_stages):
        for j in range(per):
            block = jax.tree_util.tree_map(lambda leaf: np.asarray(leaf)[s, j], j_stacked)
            want = W.gpt_state_from_jax({**jax.device_get(j_rest), "block0": block})
            for leaf, t in stacked.items():
                assert t.shape[:2] == (n_stages, per)
                assert torch.equal(t[s, j], want[f"blocks.0.{leaf}"]), (s, j, leaf)
    for k in ("tok_emb.weight", "pos_emb", "ln_f.weight", "ln_f.bias", "head.weight"):
        assert torch.equal(rest[k], state[k]) and rest[k].data_ptr() != state[k].data_ptr()


@pytest.mark.parametrize("refusal", ["layers", "devices", "n_micro"])
def test_refusals_are_jax_refusals(runs, refusal):
    """S not dividing L, S not dividing W, n_micro not dividing the batch:
    the port raises where JAX raises."""
    state, params = runs["state"], runs["params"]
    if refusal == "layers":
        with pytest.raises(ValueError, match="not divisible by n_stages=3"):
            stack_block_params(state, GPT_KW["n_layer"], 3)
        with pytest.raises(ValueError):
            j_stack(params, GPT_KW["n_layer"], 3)
    elif refusal == "devices":
        for r in runs["ranks"]["_mesh_error"]:
            assert "not divisible by n_stages=3" in r
        with pytest.raises(ValueError):
            j_pipeline_mesh(3, jax.devices()[:4])
    else:
        stacked, rest = stack_block_params(state, GPT_KW["n_layer"], 1)
        gpt = GPT(**GPT_KW)
        with pytest.raises(ValueError, match="multiple of n_micro=3"):
            pipelined_gpt_logits(gpt, shard_stacked(stacked, None, 2), rest,
                                 runs["batches"][0][0], None, 3)
        mesh = j_pipeline_mesh(4, jax.devices()[:4])
        j_stacked, j_rest = j_stack(params, GPT_KW["n_layer"], 4)
        with pytest.raises(ValueError):
            j_pipelined_logits(JaxGPT(**GPT_KW), j_shard_stacked(j_stacked, mesh), j_rest,
                               j_shard_batch(np.asarray(runs["batches"][0][0]), mesh), mesh, 3)


# -- the pipeline ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,key", [("pipe4", (4, 4)), ("pipe2x2", (2, 2)),
                                      ("pipe4_m2", (4, 2)), ("pipe2", (2, 2))])
def test_pipelined_logits_match_jax_and_plain(runs, name, key):
    want = runs["jax"]["logits"][key]
    ranks = runs["ranks"][name]
    data = len(ranks) // key[0]
    for r, got in enumerate(ranks):
        rows = slice(r // key[0] * 8 // data, (r // key[0] + 1) * 8 // data)
        np.testing.assert_allclose(got["logits"].numpy(), want[rows], atol=1e-5, rtol=0)
        torch.testing.assert_close(got["logits"], runs["plain"]["logits"][rows], atol=1e-5,
                                   rtol=0)


@pytest.mark.parametrize("name", ["pipe4", "pipe2x2", "pipe2"])
def test_pipelined_step_gradients_match_plain(runs, name):
    """The first step's gradients on every rank, before the optimizer: its
    stage's blocks and the replicated leaves, leaf by leaf."""
    plain = runs["plain"]["grads"]
    for r in runs["ranks"][name]:
        name_of = _stage_names(r)
        got = {(name_of(k) if k.startswith("stage.") else k): g for k, g in r["grads"].items()}
        assert len(got) == len(r["grads"])
        _check_grads(got, plain, 1e-5)
        # the optimizer holds moments for the rank's own stage and rest only
        assert r["moments"] == r["params"]
        assert sum(r["params"]) < sum(g.numel() for g in plain.values())


def test_pipelined_step_matches_jax_step(runs):
    """JAX's pipelined Adam step at S = 4, n_micro = 4: the loss, and the
    updated stage of every rank."""
    want = runs["jax"]["updated"]
    for r in runs["ranks"]["pipe4"]:
        assert r["losses"][0] == pytest.approx(runs["jax"]["loss"], rel=1e-6)
        name_of = _stage_names(r)
        for k, v in r["stage_after_1"].items():
            np.testing.assert_allclose(v.numpy(), want[name_of("stage." + k)].numpy(), atol=5e-5,
                                       rtol=0)


@pytest.mark.parametrize("name", ["pipe4", "pipe2x2", "pipe2"])
def test_pipelined_trajectory_matches_single_process(runs, name):
    """3 Adam steps: the losses, and the gathered stages with the
    replicated leaves against the single process, by the trajectory rule;
    each hop's backward ran (the GPipe schedule's reverse hops)."""
    plain = runs["plain"]
    n_micro = {**TWO, **FOUR}[name]["n_micro"]
    for r in runs["ranks"][name]:
        hops = n_micro + r["stage"][1] - 2         # every tick's but the last
        assert r["hops"] == (hops, hops)
        for got, want in zip(r["losses"], plain["losses"]):
            assert got == pytest.approx(want, rel=1e-5)
        state = unstack_block_params(r["gathered"], r["rest"])
        near = total = 0
        for k, v in plain["state"].items():
            d = (state[k] - v).abs()
            assert float(d.max()) <= 2 * LR * STEPS, (k, float(d.max()))
            near, total = near + int((d <= LR / 10).sum()), total + d.numel()
        assert near >= 0.99 * total


def test_unstacked_gpt_samples_the_single_process_tokens(runs):
    """The 2-stage pipeline's GPT after 3 steps, gathered and unstacked into
    a ``GPT``: ``sample_tokens`` on the CPU (the decode stack's plain
    version) gives every token the single process's GPT gives, at
    temperature 1e-4."""
    r = runs["ranks"]["pipe2"][0]
    piped, plain = GPT(**GPT_KW), GPT(**GPT_KW)
    piped.load_state_dict(unstack_block_params(r["gathered"], r["rest"]))
    plain.load_state_dict(runs["plain"]["state"])
    prefix = runs["batches"][0][0][:, :1]
    out = [sample_tokens(g, prefix, 1, 15, temperature=1e-4, top_k=None,
                         generator=torch.Generator().manual_seed(0)) for g in (piped, plain)]
    assert out[0].shape == (8, 15)
    assert torch.equal(out[0], out[1])


# -- sequence parallelism -------------------------------------------------------------------

@pytest.mark.parametrize("name,devices", [("sp1x2", 2), ("sp2x2", 4), ("tp_sp2x2", 4)])
def test_sequence_parallel_matches_jax(runs, name, devices):
    """Logits and gradients against JAX's act_sharding GPT on the same mesh,
    and the plain GPT's; one K/V gather a block forward, one reduce-scatter
    a block backward, one logits gather. ``tp_sp2x2`` is also sharded by
    ``param_sharding: tp`` (Megatron-SP), whose parallel layers move the
    sequence: the GPT runs no gather of its own."""
    want_logits, want_grads = runs["jax"]["sp"][devices]
    ranks = runs["ranks"][name]
    data = devices // 2
    for r, got in enumerate(ranks):
        rows = slice(r // 2 * 8 // data, (r // 2 + 1) * 8 // data)
        np.testing.assert_allclose(got["logits"].numpy(), want_logits[rows], atol=1e-5, rtol=0)
        torch.testing.assert_close(got["logits"], runs["plain"]["logits"][rows], atol=1e-5,
                                   rtol=0)
        n = 0 if name.startswith("tp") else GPT_KW["n_layer"]
        assert got["calls"] == (n, n, min(n, 1))
        grads = dict(got["grads"])
        for k in [k for k in grads if k.endswith("attn.key.bias")]:   # by the block rule
            assert float((grads.pop(k) - want_grads[k]).abs().max()) <= 2e-5 * _block_scale(
                want_grads, k)
        for k, g in grads.items():
            np.testing.assert_allclose(g.numpy(), want_grads[k].numpy(), atol=2e-5, rtol=0)
        _check_grads(got["grads"], runs["plain"]["grads"], 2e-5)


# -- the GPT worker's optimizer under tensor parallelism --------------------------------------

@pytest.mark.parametrize("mode,foreach", [("tp", False), ("tp_2x2", False), ("fsdp", None),
                                          ("tp_fsdp", None)])
def test_adamw_runs_tensor_by_tensor_where_tp_mixes_dtensors(runs, mode, foreach):
    """Under ``param_sharding: tp`` alone the embeddings and LayerNorms stay
    plain tensors beside the DTensors, a group AdamW's foreach kernels
    refuse on CUDA: the GPT worker's AdamW steps one tensor at a time there
    (``tp_2x2``: on a 2 x 2 mesh); under FSDP every parameter is a DTensor
    and torch chooses."""
    for r in runs["ranks"][f"worker_{mode}"]:
        assert r == [foreach, foreach]

"""The GPT prior's ``param_sharding`` modes (``parallel/sharding.py``) over
gloo ranks spawned on the CPU, against the JAX package's rules and the
port's replicated GPT in one process.

The GPT is tiny_config's prior widened to n_embd 64 (4 heads), so that its
MLP weights (64 x 256) reach the 2^14 elements from which JAX's FSDP rule
shards a leaf. One spawn of 2 ranks runs ``tp`` (a 1 x 2 mesh) and
``fsdp`` (2 x 1), one of 4 ranks ``tp_fsdp`` and ``tp`` again (2 x 2);
each takes 2 steps on the same global batches as this process's
replicated worker.

Tolerances: the ``tp`` logits within 1e-5 of the plain forward (the JAX
package's ``test_tp_rules_match_real_gpt_params``); each mode's loss within
2e-4 relative of the replicated one at each step (its
``test_fsdp_training_step``); placements exactly JAX's specs, mapped
through ``weights.py``'s names and the kernel's transpose, but for the two
stated departures (a column-parallel bias sharded with its outputs; a leaf
JAX keeps replicated under FSDP sharded on dim 0, strided where tensor
parallelism shards that dim too); the gathered checkpoint
and the resumed one equal tensor for tensor.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parallel_ranks import build_worker, gpt_modes, spawn
from vq_vae_gan_diffusion_torch import weights as W
from vq_vae_gan_diffusion_torch.parallel import (fsdp_dim, gpt_param_sharding_rules,
                                                 resolve_sharding_rules)
from vq_vae_gan_diffusion_tpu.models.mingpt import GPT as JaxGPT
from vq_vae_gan_diffusion_tpu.parallel import create_mesh as j_create_mesh
from vq_vae_gan_diffusion_tpu.parallel import resolve_sharding_rules as j_resolve

STEPS, BATCH = 2, 4
TP_MODULES = ("attn.query", "attn.key", "attn.value", "attn.proj", "mlp.0", "mlp.2")


@pytest.fixture(autouse=True, scope="module")
def few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _gpt_config(tiny_config) -> dict:
    cfg = tiny_config.replace_path("architecture.model_name", "vqvae_transformer") \
        .replace_path("architecture.vqvae_transformer.n_embd", 64)
    return cfg.to_dict()


@pytest.mark.parametrize("mode", ["replicated", "none", "", "tp", "fsdp", "tp_fsdp", "fsdp_tp",
                                  "TP_FSDP"])
def test_resolve_sharding_rules_modes(mode):
    """The modes JAX's ``resolve_sharding_rules`` takes, and the same
    answer: replicated where JAX gives no rules, else tp and fsdp as the
    mode names them."""
    plan = resolve_sharding_rules(mode)
    want = j_resolve(mode, j_create_mesh(jax.devices()[:2]))
    assert (plan is None) == (want is None)
    if plan is not None:
        assert plan.tp == ("tp" in mode.lower()) and plan.fsdp == ("fsdp" in mode.lower())


def test_resolve_sharding_rules_refuses():
    for mode in ("pp", "zero3", "tp+fsdp"):
        with pytest.raises(ValueError, match="unknown param_sharding"):
            resolve_sharding_rules(mode)
        with pytest.raises(ValueError, match="unknown param_sharding"):
            j_resolve(mode, j_create_mesh(jax.devices()[:2]))


def _jax_specs(cfg: dict, data: int, model: int, mode: str) -> dict:
    """JAX's spec of each GPT leaf under ``mode`` on a data x model mesh, by
    the port's parameter name: each leaf's index written into it, carried
    through ``weights.gpt_state_from_jax``."""
    a = cfg["architecture"]["vqvae_transformer"]
    k = int(cfg["architecture"]["vqvae"]["num_codebook_vectors"])
    gpt = JaxGPT(vocab_size=k, block_size=int(a["block_size"]), n_layer=int(a["n_layer"]),
                 n_head=int(a["n_head"]), n_embd=int(a["n_embd"]))
    params = gpt.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    mesh = j_create_mesh(jax.devices()[:data * model], model_parallel=model)
    rules = j_resolve(mode, mesh)
    flat, tree = jax.tree_util.tree_flatten_with_path(params)
    specs = [tuple(rules(path, leaf)) for path, leaf in flat]
    marked = jax.tree_util.tree_unflatten(tree, [np.full(leaf.shape, i, np.float32)
                                                 for i, (_, leaf) in enumerate(flat)])
    out = {}
    for name, t in W.gpt_state_from_jax(marked).items():
        if name.endswith("mask"):
            continue
        spec = specs[int(t.reshape(-1)[0])]
        spec = spec + (None,) * (t.dim() - len(spec))
        if t.dim() == 2 and name != "tok_emb.weight":          # the kernel's transpose
            spec = spec[::-1]
        out[name] = spec
    return out


def _want_placements(name: str, shape, spec: tuple, mode: str):
    """The placements over the port's mesh that JAX's ``spec`` asks for, with
    the two departures the module docstring states."""
    from torch.distributed.tensor import Replicate, Shard

    def dim_of(axis):
        return next((d for d, s in enumerate(spec) if s == axis), None)
    tp, fsdp = dim_of("model"), dim_of("data")
    if "tp" in mode and tp is None and gpt_param_sharding_rules(name, shape) == 0:
        tp = 0                                     # a column-parallel bias
    if "fsdp" in mode and fsdp is None:
        fsdp = 0                                   # FSDP2 shards every leaf it wraps
    tp_p = Replicate() if tp is None else Shard(tp)
    fsdp_p = Shard(fsdp) if fsdp is not None else None
    module = name.rpartition(".")[0]
    parallel = module == "head" or module.endswith(TP_MODULES)    # a DTensor over 'model'
    if mode == "tp":
        return (tp_p,) if parallel else None
    if mode == "fsdp" or not parallel:
        return (fsdp_p,)
    if fsdp == tp:                      # both on one dim: FSDP's shards interleave TP's
        from torch.distributed.tensor.placement_types import _StridedShard
        fsdp_p = _StridedShard(fsdp, split_factor=2)
    return fsdp_p, tp_p


@pytest.fixture(scope="module")
def runs(tiny_config, tmp_path_factory):
    """tp and fsdp over 2 ranks, tp_fsdp over 4, and the replicated worker
    in this process, on the same batches."""
    tmp = str(tmp_path_factory.mktemp("sharding"))
    cfg = _gpt_config(tiny_config)
    rs = np.random.RandomState(0)
    batches = [rs.uniform(-1, 1, (BATCH, 32, 32, 3)).astype(np.float32) for _ in range(STEPS)]
    idx = torch.from_numpy(rs.randint(0, 64, (2, 16)))
    job = {"cfg_dict": cfg, "batches": batches, "idx": idx}
    four = spawn(gpt_modes, ({"tp_fsdp": {**job, "mode": "tp_fsdp", "mp": 2,
                                          "artifacts": True},
                              "tp_2x2": {**job, "mode": "tp", "mp": 2}},), 4, tmp)
    two = spawn(gpt_modes, ({"tp": {**job, "mode": "tp", "mp": 2},
                             "fsdp": {**job, "mode": "fsdp", "mp": 1, "resume": True}},), 2, tmp)
    worker = build_worker(cfg)
    with torch.no_grad():
        logits = worker.state.gpt(idx)
    metrics = []
    for b in batches:
        worker.state, m = worker.train_multi_step(worker.state, [torch.from_numpy(b)],
                                                  worker.generator)
        metrics.append({k: float(v) for k, v in m.items()})
    fours = four()
    ranks = {**{k: [r[k] for r in two()] for k in ("tp", "fsdp")},
             **{k: [r[k] for r in fours] for k in ("tp_fsdp", "tp_2x2")}}
    return {"cfg": cfg, "logits": logits, "metrics": metrics, "ranks": ranks,
            "state": {k: v.clone() for k, v in worker.state.gpt.state_dict().items()}}


def test_tp_fsdp_hook_samples_on_rank0_from_the_gathered_gpt(runs):
    """``log_artifacts`` under tp_fsdp: every rank gathers, rank 0 alone
    writes the grid, and the ranks go on in step."""
    for r in runs["ranks"]["tp_fsdp"]:
        assert r["artifact"] == ["transformer_epoch0_0.jpg"]


def test_tp_logits_match_the_plain_forward(runs):
    for r in runs["ranks"]["tp"]:
        torch.testing.assert_close(r["logits"], runs["logits"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode,data,model", [("tp", 1, 2), ("fsdp", 2, 1), ("tp_fsdp", 2, 2)])
def test_placements_follow_the_jax_rules(runs, mode, data, model):
    """Every parameter's placements, before and after the steps, and its
    AdamW moments', against JAX's spec for the same leaf."""
    specs = _jax_specs(runs["cfg"], data, model, mode)
    shapes = {k: tuple(v.shape) for k, v in runs["state"].items()}
    sharded = 0
    for r in runs["ranks"][mode]:
        assert r["placements"].keys() == specs.keys() - {k for k in specs if "mask" in k}
        for when in ("placements", "placements_after"):
            for name, (placements, _) in r[when].items():
                want = _want_placements(name, shapes[name], specs[name], mode)
                assert placements == want, (when, name, placements, specs[name])
                sharded += placements is not None
        for name, moments in r["moments"].items():
            assert set(moments) == {"exp_avg", "exp_avg_sq"}
            assert all(p == r["placements_after"][name][0] for p in moments.values()), name
    assert sharded
    if "fsdp" in mode:         # the leaves JAX's rule shards over 'data'
        assert [k for k, s in specs.items() if "data" in s] == [
            k for k in specs if k.endswith(("mlp.0.weight", "mlp.2.weight"))]


def test_fsdp_dim_is_the_jax_rule():
    assert fsdp_dim((256, 64), 2) == 0 and fsdp_dim((256, 64), 2, taken=0) == 1
    assert fsdp_dim((63, 64), 2) is None and fsdp_dim((1, 3), 2, min_size=1) is None
    assert fsdp_dim((4096, 8), 4) == 0 and fsdp_dim((8, 8), 2) is None


@pytest.mark.parametrize("mode", ["tp", "fsdp", "tp_fsdp", "tp_2x2"])
def test_sharded_steps_match_replicated(runs, mode):
    """Each mode's loss and token accuracy at both steps within 2e-4
    relative of the replicated worker's (the ranks agree exactly);
    ``tp_2x2`` is tp on a 2 x 2 mesh, its sharded gradients averaged over
    the data ranks by the port's all-reduce."""
    ranks = runs["ranks"][mode]
    assert all(r["metrics"] == ranks[0]["metrics"] for r in ranks)
    for got, want in zip(ranks[0]["metrics"], runs["metrics"]):
        for k in want:
            assert got[k] == pytest.approx(want[k], rel=2e-4), (k, got[k], want[k])


def test_fsdp_checkpoint_loads_into_one_process_and_resumes_sharded(runs, tmp_path):
    """The fsdp ranks' checkpoint (written by rank 0 from the gathered
    tensors) in the single-process format: a non-distributed worker resumes
    it tensor for tensor, and a sharded worker resumed from it gathers the
    same parameters and optimizer state."""
    import copy

    r0 = runs["ranks"]["fsdp"][0]
    saved = torch.load(r0["ckpt"], weights_only=True)
    assert saved["step"] == STEPS and saved["state"]["step"] == STEPS
    cfg = copy.deepcopy(runs["cfg"])
    cfg["architecture"]["vqvae_transformer"]["resume_path"] = r0["ckpt"]
    one = build_worker(cfg)
    assert one.global_step == STEPS and one.state.step == STEPS
    for k, v in one.state.gpt.state_dict().items():
        assert torch.equal(v, saved["state"]["gpt"][k]), k
    for r in runs["ranks"]["fsdp"]:
        assert r["resumed_step"] == STEPS
        for k, v in saved["state"]["gpt"].items():
            assert torch.equal(r["resumed"][k], v), k
        want = saved["state"]["opt"]["state"]
        for i, st in r["resumed_opt"]["state"].items():
            for k, v in st.items():
                assert torch.equal(v, want[i][k]), (i, k)
    # the replicated worker's steps from the same weights land close by
    for k, v in runs["state"].items():
        assert torch.allclose(saved["state"]["gpt"][k], v, atol=2 * 4.5e-4 * STEPS), k

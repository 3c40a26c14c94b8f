"""What the port's data-parallel tests run in spawned CPU ranks, and in the
test process for the single-process side.

This module imports torch and the port only, never ``jax``: each spawned
rank imports it afresh (``torch.multiprocessing`` spawns), and must start
in seconds. A rank joins a gloo group from a ``FileStore`` under the test's
``tmp_path`` (no TCP port, so parallel test workers cannot collide), runs
one intra-op thread, and writes what it computed to ``rank<r>.pt``.
"""

from __future__ import annotations

import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist


def join_group(rank: int, world: int, store: str) -> None:
    """One gloo rank of ``world`` over the ``FileStore`` at ``store``."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)


def _child(rank: int, world: int, store: str, out_dir: str, target: Callable,
           args: tuple) -> None:
    join_group(rank, world, store)
    try:
        result = target(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn(target: Callable, args: tuple, world: int, tmp: str):
    """Start ``world`` gloo ranks, each running ``target(*args)``; returns a
    function that waits for them (at most ``timeout`` seconds) and gives
    each rank's result, in rank order. The caller works meanwhile."""
    import torch.multiprocessing as mp

    out = tempfile.mkdtemp(dir=tmp)
    store = os.path.join(out, "store")
    ctx = mp.start_processes(_child, args=(world, store, out, target, args), nprocs=world,
                             join=False, start_method="spawn")

    def wait(timeout: float = 300.0) -> List[Any]:
        end = time.monotonic() + timeout
        while not ctx.join(timeout=max(1.0, end - time.monotonic())):
            if time.monotonic() > end:
                for p in ctx.processes:
                    p.kill()
                raise TimeoutError(f"ranks still running after {timeout} s")
        return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
    return wait


# -- the families' steps -------------------------------------------------------------------

def _snapshot(worker) -> Dict[str, Any]:
    """The worker's checkpoint tree with every tensor cloned."""
    def clone(node):
        if isinstance(node, torch.Tensor):
            return node.detach().clone()
        if isinstance(node, dict):
            return {k: clone(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(clone(v) for v in node)
        return node
    return clone(worker.checkpoint_tree()["state"])


def build_worker(cfg_dict: dict, init: Optional[str] = None, **kwargs):
    """The port's worker of ``cfg_dict`` on the CPU (seed 0), with its state:
    the seeded one, or for stage 1 the modules of the file ``init`` (the
    VQVAE, the discriminator and LPIPS, as a test transplanted them; waited
    for while the test writes it)."""
    from vq_vae_gan_diffusion_torch.config import config_from_dict
    from vq_vae_gan_diffusion_torch.train import ONECYCLE_MODELS, worker_class

    cfg = config_from_dict(cfg_dict)
    model = cfg.architecture.model_name
    if model in ONECYCLE_MODELS:
        kwargs.setdefault("num_iters_per_epoch", 4)
    worker = worker_class(model)(cfg, tempfile.mkdtemp(), device="cpu", seed=0, **kwargs)
    if init is None:
        worker.state = worker.init_state()
    else:
        from vq_vae_gan_diffusion_torch.models.discriminator import Discriminator
        from vq_vae_gan_diffusion_torch.models.vqvae import VQVAE

        end = time.monotonic() + 300
        while not os.path.exists(init) and time.monotonic() < end:  # the test writes it
            time.sleep(0.2)
        tree = torch.load(init, weights_only=True)
        vqvae = VQVAE.from_config(cfg)
        vqvae.load_state_dict(tree["vqvae"])
        disc = Discriminator(3)
        disc.load_state_dict(tree["disc"])
        worker.lpips.load_state_dict(tree["lpips"])
        worker.state = worker.make_state(vqvae, disc)
    worker.replicate_state()
    return worker


def family_steps(cfg_dict: dict, batches: Sequence[np.ndarray], init: Optional[str] = None,
                 warm_lt: bool = False, float64: bool = False) -> Dict[str, Any]:
    """The worker of ``cfg_dict`` through one step on each of the global
    ``batches`` (this rank's rows of each under a group): each step's
    metrics as the loop writes them (the mean over the data ranks) and
    gradients (the global batch's), and the state after the steps.
    ``warm_lt`` starts VQ_Official's history past its warm-up (every count
    11, a drawn history), so the steps draw t by importance. ``float64`` runs the modules and batches in float64."""
    from vq_vae_gan_diffusion_torch.diffusion.discrete import LtState
    from vq_vae_gan_diffusion_torch.parallel import all_reduce_mean, shard_batch

    worker = build_worker(cfg_dict, init)
    if float64:
        for m in [*vars(worker.state).values(), getattr(worker, "composite", None)]:
            if isinstance(m, torch.nn.Module):
                m.double()
    if warm_lt:
        lt = worker.state.lt
        hist = torch.linspace(0.5, 2.0, lt.Lt_history.shape[0])
        worker.state.lt = LtState(hist, torch.full_like(lt.Lt_count, 11.0), lt.acc_ema,
                                  lt.keep_ema)
    before = _snapshot(worker)
    modules = [m for m in vars(worker.state).values() if isinstance(m, torch.nn.Module)]
    metrics, grads = [], []
    for b in batches:
        local = shard_batch(torch.from_numpy(b).to(torch.float64 if float64 else torch.float32),
                            worker.mesh)
        worker.state, m = worker.train_multi_step(worker.state, [local], worker.generator)
        values = [v.detach().clone() for v in m.values()]
        all_reduce_mean(values, worker.mesh)
        metrics.append({k: float(v) for k, v in zip(m, values)})
        grads.append({f"{i}.{k}": p.grad.clone() for i, m in enumerate(modules)
                      for k, p in m.named_parameters() if p.grad is not None})
    return {"metrics": metrics, "before": before, "after": _snapshot(worker), "grads": grads,
            "generator": worker.generator.get_state()}


def families(jobs: Dict[str, dict]) -> Dict[str, Any]:
    """:func:`family_steps` of each job (its keyword arguments), by name;
    under a group also ``create_mesh(3)``'s refusal (``"_mesh_error"``)."""
    from vq_vae_gan_diffusion_torch.parallel import create_mesh

    out = {name: family_steps(**job) for name, job in jobs.items()}
    if dist.is_initialized():
        try:
            create_mesh(3)
        except ValueError as e:
            out["_mesh_error"] = str(e)
    return out


def cli_runs(config: str) -> Dict[str, Any]:
    """The train CLI in ``--debug`` on the CPU, then again resumed from its
    checkpoint: each run's dir, batch size and the rows of its first
    batch."""
    from vq_vae_gan_diffusion_torch.config import resolve_batch_size
    from vq_vae_gan_diffusion_torch.train import cli

    first = cli.run(["--config", config, "--debug", "--device", "cpu"])
    ckpt = os.path.join(first["run_dir"], "ckpt", "step_00000002.pth")
    dist.barrier()
    second = cli.run(["--config", config, "--debug", "--device", "cpu"],
                     overrides={"architecture.vqvae.resume_path": ckpt})
    out = {}
    for name, run in (("first", first), ("second", second)):
        w = run["worker"]
        out[name] = {"run_dir": run["run_dir"], "batch": resolve_batch_size(w.config),
                     "step": w.global_step, "metrics": run["metrics"],
                     "vqvae": {k: v.clone() for k, v in w.state.vqvae.state_dict().items()}}
    return out


# -- the GPT prior's parameter sharding ------------------------------------------------------

def _placements(module) -> Dict[str, Any]:
    """Each parameter's placements (None where it is a plain tensor) and
    its local shape."""
    from torch.distributed.tensor import DTensor

    return {n: (tuple(p.placements) if isinstance(p, DTensor) else None,
                tuple((p.to_local() if isinstance(p, DTensor) else p).shape))
            for n, p in module.named_parameters()}


def _moments(worker) -> Dict[str, Any]:
    """The placements of each parameter's AdamW moments."""
    from torch.distributed.tensor import DTensor

    names = {id(p): n for n, p in worker.state.gpt.named_parameters()}
    out = {}
    for p, st in worker.state.opt.state.items():
        out[names[id(p)]] = {k: tuple(v.placements) if isinstance(v, DTensor) else None
                             for k, v in st.items() if k.startswith("exp_avg")}
    return out


def gpt_sharding(cfg_dict: dict, mode: str, mp: int, batches: Sequence[np.ndarray],
                 idx: torch.Tensor, resume: bool = False,
                 artifacts: bool = False) -> Dict[str, Any]:
    """The GPT worker under ``param_sharding: mode`` on a mesh ``mp`` wide on
    ``model``: the logits of ``idx`` and the placements before the steps,
    each step's metrics (the mean over the data ranks), with ``artifacts``
    rank 0's ``log_artifacts`` grid, the placements of the parameters and
    moments after, the gathered checkpoint (rank 0 writes it), and with
    ``resume`` that checkpoint resumed into a sharded worker and gathered
    again."""
    import copy

    from vq_vae_gan_diffusion_torch.parallel import all_reduce_mean, broadcast_object, shard_batch

    cfg = copy.deepcopy(cfg_dict)
    cfg["trainer"]["mesh_model_parallel"] = mp
    cfg["trainer"]["vqvae_transformer"]["param_sharding"] = mode
    worker = build_worker(cfg)
    out: Dict[str, Any] = {"placements": _placements(worker.state.gpt)}
    with torch.no_grad():
        out["logits"] = worker.state.gpt(idx).detach().clone()
    out["metrics"] = []
    for b in batches:
        local = shard_batch(torch.from_numpy(b), worker.mesh)
        worker.state, m = worker.train_multi_step(worker.state, [local], worker.generator)
        values = [v.detach().clone() for v in m.values()]
        all_reduce_mean(values, worker.mesh)
        out["metrics"].append({k: float(v) for k, v in zip(m, values)})
    if artifacts:                   # rank 0's hook on the gathered GPT
        worker.on_rank0(worker.log_artifacts, torch.from_numpy(batches[-1]), 0, 0)
        out["artifact"] = broadcast_object(
            [f for f in os.listdir(worker.run_dir) if f.endswith(".jpg")], worker.mesh)
    out["placements_after"] = _placements(worker.state.gpt)
    out["moments"] = _moments(worker)
    worker.global_step = len(batches)
    out["ckpt"] = broadcast_object(worker.save(0), worker.mesh)
    if resume:
        cfg["architecture"]["vqvae_transformer"]["resume_path"] = out["ckpt"]
        again = build_worker(cfg)
        with again.full_state():
            out["resumed"] = {k: v.clone() for k, v in again._full["gpt"].items()}
            out["resumed_opt"] = again._full["opt"]
        out["resumed_step"] = again.global_step
    return out


def gpt_modes(jobs: Dict[str, dict]) -> Dict[str, Any]:
    """:func:`gpt_sharding` of each job, by name."""
    return {name: gpt_sharding(**job) for name, job in jobs.items()}


# -- the GPT prior's pipeline and sequence parallelism ---------------------------------------

def _pipeline_steps(state: Dict[str, torch.Tensor], gpt_kw: dict, batches: Sequence[tuple],
                    n_stages: int, n_micro: int, lr: float) -> Dict[str, Any]:
    """The pipelined GPT of ``state`` on a pipe of ``n_stages``: its logits
    of the first batch, then an Adam step on each (idx, targets) of
    ``batches``: the losses, the first step's reduced gradients, the stage
    after the first step and the optimizer's moments, and the stages
    gathered after the last step."""
    from vq_vae_gan_diffusion_torch.models.mingpt import GPT
    from vq_vae_gan_diffusion_torch.parallel import (create_pipeline_mesh, gather_stacked, hop,
                                                     make_pipeline_train_step, pipe_shape,
                                                     pipelined_gpt_logits, shard_stacked,
                                                     stack_block_params)

    gpt = GPT(**gpt_kw)
    mesh = create_pipeline_mesh(n_stages)
    stacked, rest = stack_block_params(state, gpt.n_layer, n_stages)
    stage = shard_stacked(stacked, mesh, gpt.n_head)
    out: Dict[str, Any] = {"stage": pipe_shape(mesh)}
    with torch.no_grad():
        out["logits"] = pipelined_gpt_logits(gpt, stage, rest, batches[0][0], mesh, n_micro)
    step = make_pipeline_train_step(gpt, lambda ps: torch.optim.Adam(ps, lr=lr), mesh, n_micro)
    opt, out["losses"] = None, []
    hops = hop.calls, hop.grad_calls
    for i, (idx, targets) in enumerate(batches):
        (stage, rest), opt, loss = step((stage, rest), opt, idx, targets)
        out["losses"].append(float(loss))
        if i == 0:
            out["hops"] = hop.calls - hops[0], hop.grad_calls - hops[1]
            out["grads"] = {**{f"stage.{k}": p.grad.clone() for k, p in stage.named_parameters()},
                            **{k: v.grad.clone() for k, v in rest.items()}}
            out["stage_after_1"] = {k: p.detach().clone() for k, p in stage.named_parameters()}
    out["moments"] = sorted(st["exp_avg"].numel() for st in opt.state.values())
    out["params"] = sorted(p.numel() for p in [*stage.parameters(), *rest.values()])
    out["gathered"] = gather_stacked(stage, mesh)
    out["rest"] = {k: v.detach().clone() for k, v in rest.items()}
    return out


def _sequence_grads(state: Dict[str, torch.Tensor], gpt_kw: dict, idx: torch.Tensor,
                    targets: torch.Tensor, mp: int, tp: bool = False) -> Dict[str, Any]:
    """``GPT(act_sharding=create_mesh(mp))`` of ``state``, with ``tp`` also
    sharded by ``param_sharding: tp`` (Megatron-SP): the logits of ``idx``,
    the loss on ``targets`` and the reduced gradients (gathered whole),
    with the explicit collectives they took."""
    import torch.nn.functional as F
    from torch.distributed.tensor import DTensor

    from vq_vae_gan_diffusion_torch.models.mingpt import GPT
    from vq_vae_gan_diffusion_torch.parallel import (ShardingPlan, create_mesh, gather_logits,
                                                     gather_tokens, reduce_sequence_gradients,
                                                     shard_batch, shard_gpt)

    mesh = create_mesh(mp)
    gpt = GPT(**gpt_kw, act_sharding=mesh)
    gpt.load_state_dict(state)
    if tp:
        shard_gpt(gpt, mesh, ShardingPlan(tp=True, fsdp=False))
    before = gather_tokens.calls, gather_tokens.grad_calls, gather_logits.calls
    logits = gpt(idx)
    loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           shard_batch(targets, mesh).reshape(-1))
    loss.backward()
    reduce_sequence_gradients(gpt.parameters(), mesh)
    calls = (gather_tokens.calls, gather_tokens.grad_calls, gather_logits.calls)
    return {"logits": logits.detach(), "loss": float(loss),
            "calls": tuple(a - b for a, b in zip(calls, before)),
            "grads": {k: (p.grad.full_tensor() if isinstance(p.grad, DTensor) else p.grad.clone())
                      for k, p in gpt.named_parameters()}}


def _worker_foreach(cfg_dict: dict, param_sharding: str, mp: int) -> list:
    """The GPT worker of ``cfg_dict`` under ``param_sharding`` on a mesh
    ``mp`` wide: its AdamW groups' ``foreach`` settings."""
    import copy

    cfg = copy.deepcopy(cfg_dict)
    cfg["trainer"]["mesh_model_parallel"] = mp
    cfg["trainer"]["vqvae_transformer"]["param_sharding"] = param_sharding
    return [g["foreach"] for g in build_worker(cfg).state.opt.param_groups]


def pipeline_runs(state: Dict[str, torch.Tensor], gpt_kw: dict, batches: Sequence[tuple],
                  jobs: Dict[str, dict], lr: float) -> Dict[str, Any]:
    """Each job, by name: ``{"stages": S, "n_micro": m}`` a pipeline
    (:func:`_pipeline_steps` over ``batches``, or over the first one alone
    with ``"steps": 1``), ``{"mp": mp[, "tp": True]}`` sequence parallelism
    (:func:`_sequence_grads`) on the first batch, ``{"cfg_dict": ...,
    "param_sharding": mode, "mp": mp}`` the GPT worker's AdamW
    (:func:`_worker_foreach`); and ``create_pipeline_mesh(3)``'s refusal (``"_mesh_error"``)."""
    from vq_vae_gan_diffusion_torch.parallel import create_pipeline_mesh

    out: Dict[str, Any] = {}
    for name, job in jobs.items():
        if "param_sharding" in job:
            out[name] = _worker_foreach(**job)
        elif "mp" in job:
            out[name] = _sequence_grads(state, gpt_kw, *batches[0], job["mp"], job.get("tp", False))
        else:
            out[name] = _pipeline_steps(state, gpt_kw, batches[:job.get("steps", len(batches))],
                                        job["stages"], job["n_micro"], lr)
    try:
        create_pipeline_mesh(3)
    except ValueError as e:
        out["_mesh_error"] = str(e)
    return out

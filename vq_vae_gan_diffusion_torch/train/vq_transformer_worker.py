"""Stage-2 autoregressive worker (PyTorch counterpart of the JAX
``train/vq_transformer_worker.py``): the GPT prior over the codes of a
frozen VQVAE, trained and served.

One step, as the JAX step computes it:

- :meth:`..models.vq_transformer.VQTransformer.forward`: the frozen VQVAE's
  indices, corrupted with probability 1 - ``pkeep``, SOS prepended, the
  GPT's logits against the original indices;
- ``ce_loss``, the mean cross-entropy of the logits in float32 (float64 for
  a float64 model), and ``token_accuracy``, the share of argmax hits;
- AdamW(lr, betas=(beta1, beta2), eps 1e-8) with the minGPT decay split
  (:func:`mingpt_param_groups`: weight decay 0.01 on the 2-D ``nn.Linear``
  weights only), through :func:`.base.maybe_accumulate`.

``log_artifacts`` writes the input, reconstruction, half-completion and
full-sample rows as ``transformer_epoch{e}_{i}.jpg`` (512 positions through
the fused decode stack a call at full width); checkpoints hold the frozen
VQVAE, the GPT, the optimizer and the step. ``generate_images`` samples
with the GPT as trained.

Under a process group ``trainer.<model>.param_sharding`` (``replicated``,
``tp``, ``fsdp``, ``tp_fsdp``; :mod:`..parallel.sharding`) shards the GPT and
its AdamW moments; the frozen VQVAE stays replicated. The hooks and the
checkpoint gather the whole parameters and moments on every rank
(:meth:`VQTransformerWorker.full_state`): rank 0 samples with an unsharded
copy and writes the single-process checkpoint, which a resume shards again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..checkpoint import read_training_checkpoint
from ..config import Config
from ..models.blocks import at_least_f32
from ..models.mingpt import GPT
from ..models.vq_transformer import VQTransformer
from ..parallel import resolve_sharding_rules, shard_gpt
from ..utils import make_grid, save_image, tracing
from .base import ServingWorker, TrainingWorker, maybe_accumulate

WEIGHT_DECAY = 0.01


def decay_names(gpt: GPT) -> List[str]:
    """The parameters minGPT decays: the weight of every ``nn.Linear`` (2-D).
    Biases, LayerNorm affines, ``tok_emb`` and ``pos_emb`` are exempt, as
    the JAX package's ``mingpt_decay_mask`` exempts them."""
    linear = {f"{name}.weight" for name, m in gpt.named_modules() if isinstance(m, nn.Linear)}
    return [name for name, p in gpt.named_parameters() if name in linear and p.dim() == 2]


def mingpt_param_groups(gpt: GPT) -> List[Dict[str, Any]]:
    """AdamW's two groups: :func:`decay_names` at ``WEIGHT_DECAY``, the rest at 0."""
    decay = set(decay_names(gpt))
    params = list(gpt.named_parameters())
    return [{"params": [p for n, p in params if n in decay], "weight_decay": WEIGHT_DECAY},
            {"params": [p for n, p in params if n not in decay], "weight_decay": 0.0}]


@dataclasses.dataclass
class TransformerState:
    """The trained GPT, its optimizer and the step count."""

    gpt: GPT
    opt: Any
    step: int = 0

    def state_dict(self) -> Dict[str, Any]:
        return {"gpt": self.gpt.state_dict(), "opt": self.opt.state_dict(), "step": self.step}

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        self.gpt.load_state_dict(tree["gpt"], strict=True)
        self.opt.load_state_dict(tree["opt"])
        self.step = int(tree["step"])


class VQTransformerWorker(TrainingWorker, ServingWorker):
    composite: Optional[VQTransformer] = None

    def __init__(self, config: Config, run_dir: str, logger=None, debug: bool = False,
                 seed: int = 0, save_ckpt_dir: Optional[str] = None,
                 device: Optional[str] = None, dtype: torch.dtype = torch.float32):
        super().__init__(config, run_dir, logger, debug, seed, save_ckpt_dir, device, dtype)
        self.model_name = config.architecture.model_name
        tr = config.trainer[self.model_name if self.model_name in config.trainer
                            else "vqvae_transformer"]
        self.trainer_cfg = tr
        self.lr = float(tr.learning_rate)
        self.betas = (float(tr.get("beta1", 0.9)), float(tr.get("beta2", 0.95)))
        mode = tr.get("param_sharding", config.trainer.get("param_sharding", "replicated"))
        plan = resolve_sharding_rules(str(mode))
        self.sharding = plan if self.mesh is not None else None
        self._full: Optional[Dict[str, Any]] = None

    # -- state ---------------------------------------------------------------
    def init_state(self) -> TransformerState:
        """A fresh VQTransformer with weights drawn from a generator seeded by
        ``seed`` on the worker's device, the VQVAE frozen (eval mode, no
        gradients) and replaced by the checkpoint at
        ``architecture.vqvae.resume_path`` (a stage-1 training checkpoint
        included), and a fresh optimizer; also set as the worker's state. A
        GPT training checkpoint at ``architecture.<model>.resume_path``
        replaces the whole state."""
        composite = VQTransformer(self.config)
        gen = torch.Generator().manual_seed(self.seed)
        composite.vqvae.init_weights(gen)
        composite.gpt.init_weights(gen)
        self._restore_vqvae(composite.vqvae)
        self.composite = composite.to(self.device)
        composite.vqvae.eval().requires_grad_(False)
        if self.sharding is not None:
            shard_gpt(composite.gpt, self.mesh, self.sharding)
        # tp alone leaves the embeddings and LayerNorms plain tensors beside
        # the DTensors, a mix that AdamW's foreach kernels refuse on CUDA
        mixed = self.sharding is not None and self.sharding.tp and not self.sharding.fsdp
        opt = maybe_accumulate(torch.optim.AdamW(mingpt_param_groups(composite.gpt), lr=self.lr,
                                                 betas=self.betas, eps=1e-8,
                                                 foreach=False if mixed else None),
                               self.trainer_cfg)
        state = TransformerState(composite.gpt, opt)
        n = sum(p.numel() for p in composite.gpt.parameters())
        self.logger.info("GPT params: %.1fM", n / 1e6)
        mkey = self.model_name if self.model_name in self.config.architecture else "vqvae"
        resume = self.config.architecture[mkey].get("resume_path")
        self.state = state
        tree = read_training_checkpoint(str(resume), "gpt") if resume else None
        if tree is not None:
            self.load_checkpoint_tree(tree)
            self.logger.info("GPT state resumed from %s at step %d", resume, state.step)
        return state

    def load(self, path: str) -> None:
        """Load a port checkpoint (``torch.save({"vqvae": ..., "gpt": ...})``,
        a GPT training checkpoint of this worker) or a bare minGPT or VQVAE
        ``state_dict`` as ``tools/export_torch_checkpoint.py`` writes it; a
        path where nothing exists only warns, any other unreadable path
        raises."""
        self._restore(path, "gpt", self.composite.gpt)

    def checkpoint_tree(self) -> Dict[str, Any]:
        """The single-process tree; with a sharded GPT, the whole tensors of
        :meth:`full_state`."""
        state = self.state.state_dict() if self._full is None else \
            {**self._full, "step": self.state.step}
        return {"state": {"vqvae": self.composite.vqvae.state_dict(), **state},
                "step": self.global_step}

    def load_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        """A single-process checkpoint; with a sharded GPT, each rank keeps
        its shards of the parameters and moments."""
        self.composite.vqvae.load_state_dict(tree["state"]["vqvae"], strict=True)
        if self.sharding is None:
            self.state.load_state_dict(tree["state"])
        else:
            st = tree["state"]
            with torch.no_grad():
                local = self._sharded_like(st["gpt"])
                for name, p in self.state.gpt.named_parameters():
                    p.to_local().copy_(local[name].to_local())
            self.state.opt.load_state_dict(self._sharded_opt(st["opt"]))
            self.state.step = int(st["step"])
        self.global_step = int(tree["step"])

    # -- sharded parameters --------------------------------------------------
    def _plain_gpt(self, state: Dict[str, torch.Tensor]) -> GPT:
        """An unsharded GPT of the config's shape holding ``state`` on the
        worker's device."""
        g = self.state.gpt
        gpt = GPT(g.vocab_size, g.block_size, g.n_layer, g.n_head, g.n_embd)
        gpt.load_state_dict(state, strict=False)
        return gpt.to(self.device)

    def _sharded_like(self, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """Whole tensors by parameter name -> this rank's shards of them, as
        the GPT's own parameters are sharded (a copy sharded by the same
        plan)."""
        gpt = shard_gpt(self._plain_gpt(state), self.mesh, self.sharding)
        return {n: p.data for n, p in gpt.named_parameters()}

    def _param_names(self) -> List[str]:
        """The GPT's parameter names in the optimizer's order
        (:func:`mingpt_param_groups`)."""
        decay = set(decay_names(self.state.gpt))
        names = [n for n, _ in self.state.gpt.named_parameters()]
        return [n for n in names if n in decay] + [n for n in names if n not in decay]

    def _sharded_opt(self, tree: Dict[str, Any]) -> Dict[str, Any]:
        """An optimizer ``state_dict`` of whole tensors (AdamW's or
        ``MultiSteps``') with each tensor of a parameter's shape replaced by
        this rank's shard of it."""
        names = self._param_names()
        shapes = dict((n, tuple(p.shape)) for n, p in self.state.gpt.named_parameters())

        def shard(values: Dict[int, torch.Tensor]) -> Dict[int, torch.Tensor]:
            local = self._sharded_like({names[i]: v for i, v in values.items()})
            return {i: local[names[i]] for i in values}
        inner = tree.get("inner", tree)
        keys = {k for st in inner["state"].values() for k, v in st.items()
                if isinstance(v, torch.Tensor) and v.dim() > 0}
        for key in keys:
            vals = {i: st[key] for i, st in inner["state"].items()
                    if tuple(st[key].shape) == shapes[names[i]]}
            for i, v in shard(vals).items():
                inner["state"][i][key] = v
        if "acc" in tree:
            tree["acc"] = list(shard(dict(enumerate(tree["acc"]))).values())
        return tree

    @contextlib.contextmanager
    def full_state(self):
        """With a sharded GPT: gather the whole parameters and optimizer state
        on every rank (collectives, in the same order everywhere); inside,
        the composite samples with an unsharded copy and the checkpoint
        holds the whole tensors. Nothing without sharding."""
        if self.sharding is None:
            yield
            return
        from torch.distributed.tensor import DTensor

        def whole(node):
            if isinstance(node, DTensor):
                return node.full_tensor()
            if isinstance(node, dict):
                return {k: whole(v) for k, v in node.items()}
            if isinstance(node, list):
                return [whole(v) for v in node]
            return node
        gpt_state = whole(dict(self.state.gpt.state_dict()))
        self._full = {"gpt": gpt_state, "opt": whole(self.state.opt.state_dict())}
        sharded, self.composite.gpt = self.composite.gpt, self._plain_gpt(gpt_state)
        try:
            yield
        finally:
            self.composite.gpt, self._full = sharded, None

    # -- the step ------------------------------------------------------------
    def train_step(self, state: TransformerState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   keep: Optional[torch.Tensor] = None,
                   random_indices: Optional[torch.Tensor] = None):
        """One step on ``batch`` [B, H, W, C] -> (state, metrics). The
        corruption draws come from ``generator`` unless ``keep`` and
        ``random_indices`` [B, T] are given."""
        with tracing.span("train.step"):
            imgs = batch if isinstance(batch, torch.Tensor) else self.batch_to_device(batch)
            with tracing.span("train.forward"):
                with self.autocast():
                    logits, targets = self.composite(imgs, generator, keep=keep,
                                                     random_indices=random_indices)
                logits = at_least_f32(logits)
                loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                                       targets.reshape(-1))
                acc = (logits.argmax(-1) == targets).float().mean()
            with tracing.span("train.backward"):
                state.opt.zero_grad()
                loss.backward()
                if self.sharding is None or not self.sharding.fsdp:   # FSDP reduces its own
                    self.reduce_gradients(state.gpt)
            with tracing.span("train.optimizer"):
                state.opt.step()
            state.step += 1
            return state, {"ce_loss": loss.detach(), "token_accuracy": acc.detach()}

    # -- artifacts -------------------------------------------------------------
    def log_artifacts(self, batch: torch.Tensor, epoch: int, index: int) -> None:
        """The first 4 images of ``batch``, their reconstructions, the
        completions of their first half and full samples, one row each, as
        ``transformer_epoch{epoch}_{index}.jpg``."""
        logs = self.composite.log_images(batch[:4], self.generator, dtype=self.dtype)
        rows = [self.to_uint8(logs[k]) for k in ("input", "rec", "half_sample", "full_sample")]
        save_image(make_grid(np.concatenate(rows, axis=0), nrow=4),
                   os.path.join(self.run_dir, f"transformer_epoch{epoch}_{index}.jpg"))

    @torch.no_grad()
    def generate_images(self, val_loader=None, n_samples: int = 16, epoch: int = 0,
                        temperature: float = 1.0, top_k: int = 100
                        ) -> Dict[str, object]:
        """Sample ``n_samples`` x seq_len tokens, decode them to NHWC images and
        write ``samples_epoch{epoch}.jpg`` to the run dir. ``val_loader`` is
        ignored, as in the JAX worker. Returns the tokens, the images and the
        seconds each phase took (the device is synchronised between phases)."""
        out = self._sample_and_decode(
            lambda: self.composite.sample(n_samples, temperature=temperature, top_k=top_k,
                                          generator=self.generator, dtype=self.dtype),
            self.composite.z_to_image, epoch)
        out["tokens"] = out.pop("codes")
        return out

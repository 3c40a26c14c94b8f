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
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..checkpoint import read_training_checkpoint
from ..config import Config
from ..models.mingpt import GPT
from ..models.vq_transformer import VQTransformer
from ..utils import make_grid, save_image
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
                 device: Optional[str] = None):
        super().__init__(config, run_dir, logger, debug, seed, save_ckpt_dir, device)
        self.model_name = config.architecture.model_name
        tr = config.trainer[self.model_name if self.model_name in config.trainer
                            else "vqvae_transformer"]
        self.trainer_cfg = tr
        self.lr = float(tr.learning_rate)
        self.betas = (float(tr.get("beta1", 0.9)), float(tr.get("beta2", 0.95)))

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
        opt = maybe_accumulate(torch.optim.AdamW(mingpt_param_groups(composite.gpt), lr=self.lr,
                                                 betas=self.betas, eps=1e-8), self.trainer_cfg)
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
        return {"state": {"vqvae": self.composite.vqvae.state_dict(), **self.state.state_dict()},
                "step": self.global_step}

    def load_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        self.composite.vqvae.load_state_dict(tree["state"]["vqvae"], strict=True)
        self.state.load_state_dict(tree["state"])
        self.global_step = int(tree["step"])

    # -- the step ------------------------------------------------------------
    def train_step(self, state: TransformerState, batch,
                   generator: Optional[torch.Generator] = None, *,
                   keep: Optional[torch.Tensor] = None,
                   random_indices: Optional[torch.Tensor] = None):
        """One step on ``batch`` [B, H, W, C] -> (state, metrics). The
        corruption draws come from ``generator`` unless ``keep`` and
        ``random_indices`` [B, T] are given."""
        imgs = batch if isinstance(batch, torch.Tensor) else self.batch_to_device(batch)
        logits, targets = self.composite(imgs, generator, keep=keep,
                                         random_indices=random_indices)
        logits = logits.to(torch.promote_types(logits.dtype, torch.float32))
        loss = F.cross_entropy(logits.reshape(-1, logits.shape[-1]), targets.reshape(-1))
        acc = (logits.argmax(-1) == targets).float().mean()
        state.opt.zero_grad()
        loss.backward()
        state.opt.step()
        state.step += 1
        return state, {"ce_loss": loss.detach(), "token_accuracy": acc.detach()}

    # -- artifacts -------------------------------------------------------------
    def log_artifacts(self, batch: torch.Tensor, epoch: int, index: int) -> None:
        """The first 4 images of ``batch``, their reconstructions, the
        completions of their first half and full samples, one row each, as
        ``transformer_epoch{epoch}_{index}.jpg``."""
        logs = self.composite.log_images(batch[:4], self.generator)
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

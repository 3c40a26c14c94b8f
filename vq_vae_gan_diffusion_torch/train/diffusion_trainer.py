"""What the diffusion workers' training steps share: AdamW under torch's
OneCycle schedule and the batch-adjusted EMA of the U-Net (the JAX
``train/vq_diffusion_worker.py`` and ``train/gaussian_diffusion_workers.py``
write the same lines each).

- AdamW (weight decay 0.01 on every parameter, eps 1e-8, the worker's
  beta2) with torch's OneCycle lr and beta1 (:mod:`..utils.schedules`) over
  ``max(num_epochs * num_iters_per_epoch, 10)`` updates, set before each
  update, through :func:`.base.maybe_accumulate`;
- on steps whose count before the step is a multiple of
  ``model_ema_steps``: the EMA copy moves toward the updated parameters
  with ``decay = 1 - min(1, (1 - model_ema_decay) * batch * model_ema_steps
  / num_epochs)`` (the JAX workers' own line, unclamped), and its BatchNorm
  statistics are copied from the live ones.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Callable, Dict, Optional

import torch
from torch import nn

from ..config import Config, resolve_batch_size
from ..diffusion.discrete import LtState
from ..utils import tracing
from ..utils.ema import ema_update
from ..utils.schedules import torch_onecycle_schedules
from .base import MultiSteps, TrainingWorker, maybe_accumulate

WEIGHT_DECAY = 0.01


@dataclasses.dataclass
class DiffusionState:
    """The trained U-Net, its EMA copy (parameters and BatchNorm
    statistics), the optimizer, the step count, the count of optimizer
    updates, which indexes the OneCycle schedule, and the discrete prior's
    importance-sampling history (None for the Gaussian priors)."""

    unet: nn.Module
    ema: nn.Module
    opt: Any
    step: int = 0
    updates: int = 0
    lt: Optional[LtState] = None

    def state_dict(self) -> Dict[str, Any]:
        tree = {"unet": self.unet.state_dict(), "ema": self.ema.state_dict(),
                "opt": self.opt.state_dict(), "step": self.step, "updates": self.updates}
        if self.lt is not None:
            tree["lt"] = self.lt._asdict()
        return tree

    def load_state_dict(self, tree: Dict[str, Any]) -> None:
        self.unet.load_state_dict(tree["unet"], strict=True)
        self.ema.load_state_dict(tree["ema"], strict=True)
        self.opt.load_state_dict(tree["opt"])
        self.step, self.updates = int(tree["step"]), int(tree["updates"])
        if (self.lt is None) != ("lt" not in tree):
            raise ValueError("the checkpoint's importance-sampling history does not fit "
                             "this prior")
        if self.lt is not None:
            self.lt = LtState(**{k: v.to(self.lt.Lt_history.device)
                                 for k, v in tree["lt"].items()})


class DiffusionTrainer(TrainingWorker):
    """A training worker whose state is a :class:`DiffusionState`; the
    OneCycle-scheduled workers call :meth:`_setup_schedule` and
    :meth:`_update`, the others :meth:`_step`."""

    def _setup_schedule(self, tr: Config, num_iters_per_epoch: int, beta2: float) -> None:
        """The OneCycle schedule, the EMA cadence and decay and beta2 from the
        family's trainer config ``tr``."""
        self.trainer_cfg = tr
        self.model_ema_steps = int(tr.get("model_ema_steps", 10))
        num_epochs = int(self.config.trainer.num_epochs)
        alpha = min(1.0, (1.0 - float(tr.get("model_ema_decay", 0.995)))
                    * resolve_batch_size(self.config) * self.model_ema_steps
                    / max(num_epochs, 1))
        self.ema_decay = 1.0 - alpha
        self.total_steps = max(num_epochs * num_iters_per_epoch, 10)
        # torch's OneCycleLR, as the reference uses it: its default
        # cycle_momentum=True replaces any configured beta1 with its
        # 0.95 <-> 0.85 cycle from the first step, exactly like the
        # reference and the JAX workers; beta2 is kept
        self.lr_fn, self.b1_fn = torch_onecycle_schedules(self.total_steps,
                                                          float(tr.learning_rate))
        self.beta2 = beta2

    def _new_state(self, unet: nn.Module, lt: Optional[LtState] = None) -> DiffusionState:
        """``unet`` (on the worker's device), an EMA copy of it and a fresh
        optimizer."""
        ema = copy.deepcopy(unet).eval().requires_grad_(False)
        opt = torch.optim.AdamW(unet.parameters(), lr=self.lr_fn(0),
                                betas=(self.b1_fn(0), self.beta2), eps=1e-8,
                                weight_decay=WEIGHT_DECAY)
        return DiffusionState(unet, ema, maybe_accumulate(opt, self.trainer_cfg), lt=lt)

    def checkpoint_tree(self) -> Dict[str, Any]:
        return {"state": self.state.state_dict(), "step": self.global_step}

    def load_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        self.state.load_state_dict(tree["state"])
        self.global_step = int(tree["step"])

    def _update(self, state: DiffusionState, loss: torch.Tensor) -> None:
        """:meth:`_step` at the schedule's lr and beta1, the EMA on its
        cadence."""
        self._step(state, loss, self.ema_decay, self.model_ema_steps, self._schedule)

    def _schedule(self, state: DiffusionState) -> None:
        """Set the optimizer's lr and beta1 to the schedule's at the update
        count."""
        opt = state.opt.opt if isinstance(state.opt, MultiSteps) else state.opt
        for group in opt.param_groups:
            group["lr"] = self.lr_fn(state.updates)
            group["betas"] = (self.b1_fn(state.updates), group["betas"][1])

    def _step(self, state: DiffusionState, loss: torch.Tensor, ema_decay: float,
              ema_every: int, schedule: Optional[Callable[[DiffusionState], None]] = None
              ) -> None:
        """Backward of ``loss``, the gradients averaged over the data ranks
        and one optimizer step, after ``schedule(state)`` sets its
        hyperparameters where given; on steps whose count before the step
        is a multiple of ``ema_every`` the EMA's parameters move by
        ``ema_decay`` and its buffers (BatchNorm statistics) are copied;
        moves the step count."""
        with tracing.span("train.backward"):
            state.opt.zero_grad()
            loss.backward()
            self.reduce_gradients(state.unet)
        with tracing.span("train.optimizer"):
            if schedule is not None:
                schedule(state)
            state.opt.step()
            if getattr(state.opt, "mini_step", 0) == 0:
                state.updates += 1
            if state.step % ema_every == 0:
                ema_update(state.ema, state.unet, ema_decay)
                with torch.no_grad():
                    for e, b in zip(state.ema.buffers(), state.unet.buffers()):
                        e.copy_(b)
        state.step += 1

"""What the port's workers share (counterpart of the JAX ``train/base.py``).

- :class:`Worker`: the device, the seeded generator, the dataset's mean and
  std;
- :class:`ServingWorker`: the stage-1 checkpoint and the timed sample ->
  decode -> grid run of the generation workers;
- :class:`TrainingWorker`: the epoch loop, the metric and artifact cadence,
  checkpoints and resume;
- :func:`maybe_accumulate`: ``optax.MultiSteps`` for a torch optimizer;
- :class:`ClipByGlobalNorm`: ``optax.clip_by_global_norm`` ahead of one.

Every write of the training loop (``metrics.jsonl``, images, checkpoints)
happens before the loop goes on, so an error surfaces where it happens and
nothing is left queued when the process ends.
"""

from __future__ import annotations

import logging
import os
import signal
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from ..checkpoint import restore, write_checkpoint
from ..config import Config
from ..utils import (MetricWriter, adaptive_save_step, compute_autocast, make_grid,
                     resolve_device, save_image, to_uint8)


class Worker:
    def __init__(self, config: Config, run_dir: str,
                 logger: Optional[logging.Logger] = None, seed: int = 0,
                 device: Optional[str] = None, dtype: torch.dtype = torch.float32):
        self.config = config
        self.run_dir = run_dir
        self.logger = logger or logging.getLogger("vqgd_torch")
        self.seed = seed
        self.device = resolve_device(device)
        self.dtype = dtype
        ds = config.dataset.dataset_name
        ch = int(config.dataset.img_channels[ds])
        self.dataset_name = ds
        self.mean = list(config.dataset.mean)[:ch] or [0.5]
        self.std = list(config.dataset.std)[:ch] or [0.5]
        self.generator = torch.Generator(device=self.device).manual_seed(seed)

    def autocast(self):
        """The context of the worker's forwards at its compute ``dtype``
        (:func:`..utils.compute_autocast`): bf16 autocast under ``--bf16``,
        nothing in f32. Parameters, optimizer moments, EMA copies and
        BatchNorm statistics stay f32 either way."""
        return compute_autocast(self.device, self.dtype)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def to_uint8(self, img) -> np.ndarray:
        if isinstance(img, torch.Tensor):
            img = img.detach().float().cpu().numpy()
        return to_uint8(img, self.mean, self.std)


class ServingWorker(Worker):
    def _restore_vqvae(self, vqvae: nn.Module) -> None:
        """The checkpoint at ``architecture.vqvae.resume_path`` (a bare VQVAE
        ``state_dict``, a port bundle or a training checkpoint,
        :mod:`..checkpoint`) replaces the seeded VQVAE; a path where nothing
        exists only warns."""
        resume = self.config.architecture.vqvae.get("resume_path")
        if resume:
            restore(str(resume), {"vqvae": vqvae}, self.logger, "stage-1")

    def _restore(self, path: str, prior: str, module: nn.Module) -> None:
        """Load the checkpoint at ``path``: a port bundle (VQVAE and prior) or
        a bare ``state_dict`` of either, the prior stored under ``prior``."""
        restore(path, {"vqvae": self.composite.vqvae, prior: module}, self.logger, "prior")

    def _sample_and_decode(self, sample: Callable[[], torch.Tensor],
                           decode: Callable[[torch.Tensor], torch.Tensor],
                           epoch: int) -> Dict[str, object]:
        """Run ``sample()`` then ``decode(codes)``, synchronising the device
        between phases, and write ``samples_epoch{epoch}.jpg``. Returns the
        codes, the NHWC images, the grid's path and each phase's seconds."""
        self._sync()
        t0 = time.perf_counter()
        codes = sample()
        self._sync()
        t1 = time.perf_counter()
        images = decode(codes)
        self._sync()
        t2 = time.perf_counter()
        grid = make_grid(self.to_uint8(images), nrow=4)
        path = os.path.join(self.run_dir, f"samples_epoch{epoch}.jpg")
        save_image(grid, path)
        self.logger.info("sampled %s codes in %.3f s, decoded in %.3f s -> %s",
                         tuple(codes.shape), t1 - t0, t2 - t1, path)
        return {"codes": codes, "images": images, "path": path,
                "seconds": {"sample": t1 - t0, "decode": t2 - t1}}


class MultiSteps:
    """``optax.MultiSteps`` for a torch optimizer: each :meth:`step` folds the
    parameters' gradients into a running mean (``acc + (g - acc) / (n + 1)``);
    every ``every_k``-th one hands the mean to the inner optimizer, steps it
    and clears the mean. In between, parameters and the inner state stay as
    they are."""

    def __init__(self, opt: torch.optim.Optimizer, every_k: int):
        self.opt = opt
        self.every_k = every_k
        self.mini_step = 0
        self.acc = [torch.zeros_like(p) for p in self._params()]

    def _params(self) -> List[torch.Tensor]:
        return [p for group in self.opt.param_groups for p in group["params"]]

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        n = self.mini_step
        for p, acc in zip(self._params(), self.acc):
            if p.grad is not None:
                acc.add_((p.grad - acc) / (n + 1))
            else:
                acc.sub_(acc / (n + 1))
        self.mini_step = (n + 1) % self.every_k
        if self.mini_step == 0:
            for p, acc in zip(self._params(), self.acc):
                p.grad = acc.clone()
                acc.zero_()
            self.opt.step()

    def state_dict(self) -> Dict[str, Any]:
        return {"inner": self.opt.state_dict(), "mini_step": self.mini_step, "acc": self.acc}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.opt.load_state_dict(state["inner"])
        self.mini_step = int(state["mini_step"])
        for acc, saved in zip(self.acc, state["acc"]):
            acc.copy_(saved)


class ClipByGlobalNorm:
    """``optax.chain(optax.clip_by_global_norm(max_norm), opt)`` for a torch
    optimizer: :meth:`step` rescales the gradients where their global norm
    is at least ``max_norm``, as optax does (``g / norm * max_norm``, no
    epsilon; ``torch.nn.utils.clip_grad_norm_`` divides by ``norm + 1e-6``),
    then steps ``opt``. The test stays on the device."""

    def __init__(self, opt: torch.optim.Optimizer, max_norm: float):
        self.opt, self.max_norm = opt, max_norm
        self.param_groups = opt.param_groups

    def zero_grad(self, set_to_none: bool = True) -> None:
        self.opt.zero_grad(set_to_none=set_to_none)

    @torch.no_grad()
    def step(self) -> None:
        grads = [p.grad for group in self.param_groups for p in group["params"]
                 if p.grad is not None]
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        keep = norm < self.max_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.max_norm))
        self.opt.step()

    def state_dict(self) -> Dict[str, Any]:
        return self.opt.state_dict()

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.opt.load_state_dict(state)


def maybe_accumulate(opt: torch.optim.Optimizer, trainer_cfg: Config):
    """``opt``, or :class:`MultiSteps` over it when the family's trainer
    config sets ``gradient_accumulate_every`` > 1."""
    every = int(trainer_cfg.get("gradient_accumulate_every", 1) or 1)
    return MultiSteps(opt, every) if every > 1 else opt


class TrainingWorker(Worker):
    """The epoch loop over a worker's ``train_step``. Subclasses give
    ``init_state``, ``train_step(state, batch, generator)``,
    ``checkpoint_tree``, ``load_checkpoint_tree``, ``log_artifacts`` and
    ``generate_images``."""

    keep_checkpoints = 3

    def __init__(self, config: Config, run_dir: str,
                 logger: Optional[logging.Logger] = None, debug: bool = False, seed: int = 0,
                 save_ckpt_dir: Optional[str] = None, device: Optional[str] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__(config, run_dir, logger, seed, device, dtype)
        self.debug = debug
        self.save_ckpt_dir = save_ckpt_dir or os.path.join(run_dir, "ckpt")
        self.metrics: Optional[MetricWriter] = None
        self._sigterm = False
        self.global_step = 0
        self.state: Any = None

    def batch_to_device(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch, np.float32)).to(self.device, non_blocking=True)

    def train_multi_step(self, state, batches, generator: Optional[torch.Generator] = None):
        """``train_step`` over each of ``batches`` (K batches, a list or
        [K, B, ...]) in turn; returns the state and the last step's metrics.
        The JAX worker scans K steps in one dispatch; here a Python loop
        issues them, with no device data cache (the JAX cache freezes batch
        composition after epoch 0)."""
        metrics: Dict[str, torch.Tensor] = {}
        for batch in batches:
            state, metrics = self.train_step(state, batch, generator)
        return state, metrics

    def train(self, dataloader: Iterable, epochs: int,
              val_loader: Optional[Iterable] = None) -> Dict[str, float]:
        """Train for ``epochs`` epochs (one, and two batches of it, under
        ``debug``). ``trainer.steps_per_dispatch`` K (1 under ``debug``)
        hands K batches at a time to :meth:`train_multi_step`; an epoch's
        tail of fewer than K batches runs one step at a time. Metrics go to
        ``metrics.jsonl`` on the first dispatch and every ``max(K, save_step
        // 5)`` steps after, artifacts every ``max(K, save_step)`` steps
        (:func:`..utils.adaptive_save_step` of the epoch's batches), as the
        JAX loop writes them; each epoch ends with its time and images/s, a
        checkpoint and the validation grid. An epoch's time is split into
        the host's time in the loader (reading, decoding, the copy to the
        device: ``loader_s``), in the artifacts (``artifact_s``) and the
        rest, the steps and the wait for the device at the epoch's end
        (``step_s``). Returns the last metrics written.

        SIGTERM (a preempted machine) is taken at the next dispatch's end or
        the next epoch's start, never inside the handler, which only notes
        it: the loop writes the step's metrics, saves a checkpoint and raises
        ``SystemExit(143)``. A SIGTERM noted in an earlier call (during a
        ``--profile`` epoch's checkpoint or grid) is taken before this call's
        first step. The previous handler is restored on the way out."""
        if self.state is None:
            self.state = self.init_state()

        def on_sigterm(signum, frame):
            self._sigterm = True
            self.logger.warning("SIGTERM: checkpoint and exit at the next step boundary")
        try:
            previous = signal.signal(signal.SIGTERM, on_sigterm)
        except ValueError:                       # not the main thread
            previous = None
        try:
            with MetricWriter(self.run_dir, logger=self.logger) as self.metrics:
                return self._epochs(dataloader, epochs, val_loader)
        finally:
            if previous is not None:
                signal.signal(signal.SIGTERM, previous)

    def _exit_if_terminated(self, epoch: int) -> None:
        """On a noted SIGTERM: save and raise ``SystemExit(143)``."""
        if self._sigterm:
            self.save(epoch)
            raise SystemExit(143)

    def _epochs(self, dataloader: Iterable, epochs: int,
                val_loader: Optional[Iterable]) -> Dict[str, float]:
        k = 1 if self.debug else max(1, int(self.config.trainer.get("steps_per_dispatch", 1)
                                            or 1))
        save_step = adaptive_save_step(len(dataloader))
        metric_every, artifact_every = max(k, save_step // 5), max(k, save_step)
        next_metric = next_artifact = self.global_step
        last: Dict[str, float] = {}
        steps = images = 0

        def dispatch(batches: List[torch.Tensor], epoch: int, on_cadence: bool) -> None:
            """``train_multi_step`` over ``batches``, the step counters, the
            metrics row (where ``on_cadence`` and due, or on a noted SIGTERM)
            and the SIGTERM exit."""
            nonlocal next_metric, last, steps, images
            self.state, metrics = self.train_multi_step(self.state, batches, self.generator)
            self.global_step += len(batches)
            steps += len(batches)
            images += sum(b.shape[0] for b in batches)
            write = (on_cadence and self.global_step >= next_metric) or self._sigterm
            if write or not on_cadence:
                last = {name: float(v) for name, v in metrics.items()}
            if write:
                next_metric = self.global_step + metric_every
                self.metrics.write(self.global_step, last)
            self._exit_if_terminated(epoch)

        for epoch in range(epochs):
            self._exit_if_terminated(epoch)
            t0 = t = time.perf_counter()
            images, steps, loader_s, artifact_s = 0, 0, 0.0, 0.0
            pending: List[torch.Tensor] = []
            for index, batch in enumerate(dataloader):
                pending.append(self.batch_to_device(batch))
                loader_s += time.perf_counter() - t
                if len(pending) == k:
                    batches, pending = pending, []
                    dispatch(batches, epoch, on_cadence=True)
                    if self.global_step >= next_artifact:
                        next_artifact = self.global_step + artifact_every
                        ta = time.perf_counter()
                        self.log_artifacts(batches[-1], epoch, index)
                        artifact_s += time.perf_counter() - ta
                if self.debug and index >= 1:
                    break
                t = time.perf_counter()
            if pending:                        # the tail of fewer than K: no row, as JAX's
                dispatch(pending, epoch, on_cadence=False)
            self._sync()
            dt = time.perf_counter() - t0
            self.logger.info("epoch %d done in %.1fs (%.1f images/s; loader %.2fs, artifacts "
                             "%.2fs) %s", epoch, dt, images / max(dt, 1e-9), loader_s,
                             artifact_s, last)
            self.metrics.write(self.global_step, {
                "epoch_time_s": dt, "images_per_sec": images / max(dt, 1e-9),
                "loader_s": loader_s, "artifact_s": artifact_s,
                "step_s": dt - loader_s - artifact_s, "steps": steps})
            self.save(epoch)
            if val_loader is not None:
                self.generate_images(val_loader, epoch=epoch)
            if self.debug:
                break
        return last

    def save(self, epoch: int) -> str:
        """``torch.save({"state", "step", "epoch"})`` to
        ``<save_ckpt_dir>/step_<step>.pth``, keeping the newest
        ``keep_checkpoints``; returns the path."""
        path = write_checkpoint(self.save_ckpt_dir, self.global_step,
                                {**self.checkpoint_tree(), "epoch": epoch},
                                self.keep_checkpoints)
        self.logger.info("checkpoint %s", path)
        return path

    def checkpoint_tree(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        raise NotImplementedError

    def log_artifacts(self, batch: torch.Tensor, epoch: int, index: int) -> None:
        """Every ``save_step`` steps; default: nothing."""

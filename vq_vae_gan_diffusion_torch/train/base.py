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

import glob
import logging
import os
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

import numpy as np
import torch
from torch import nn

from ..checkpoint import restore
from ..config import Config
from ..utils import (MetricWriter, adaptive_save_step, make_grid, resolve_device, save_image,
                     to_uint8)


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
                 save_ckpt_dir: Optional[str] = None, device: Optional[str] = None):
        super().__init__(config, run_dir, logger, seed, device)
        self.debug = debug
        self.save_ckpt_dir = save_ckpt_dir or os.path.join(run_dir, "ckpt")
        self.metrics: Optional[MetricWriter] = None
        self.global_step = 0
        self.state: Any = None

    def batch_to_device(self, batch) -> torch.Tensor:
        return torch.as_tensor(np.asarray(batch, np.float32)).to(self.device, non_blocking=True)

    def train_multi_step(self, state, batches, generator: Optional[torch.Generator] = None):
        """``train_step`` over each of ``batches`` ([K, B, ...]) in turn;
        returns the state and the last step's metrics."""
        metrics: Dict[str, torch.Tensor] = {}
        for batch in batches:
            state, metrics = self.train_step(state, batch, generator)
        return state, metrics

    def train(self, dataloader: Iterable, epochs: int,
              val_loader: Optional[Iterable] = None) -> Dict[str, float]:
        """Train for ``epochs`` epochs (one, and two batches of it, under
        ``debug``). Metrics go to ``metrics.jsonl`` on the first step and
        every ``save_step // 5`` steps after, artifacts every ``save_step``
        steps (:func:`..utils.adaptive_save_step` of the epoch's batches);
        each epoch ends with its time and images/s, a checkpoint and the
        validation grid. An epoch's time is split into the host's time in
        the loader (reading, decoding, the copy to the device: ``loader_s``),
        in the artifacts (``artifact_s``) and the rest, the steps and the
        wait for the device at the epoch's end (``step_s``). Returns the last
        metrics written."""
        if self.state is None:
            self.state = self.init_state()
        with MetricWriter(self.run_dir) as self.metrics:
            return self._epochs(dataloader, epochs, val_loader)

    def _epochs(self, dataloader: Iterable, epochs: int,
                val_loader: Optional[Iterable]) -> Dict[str, float]:
        save_step = adaptive_save_step(len(dataloader))
        metric_every, artifact_every = max(1, save_step // 5), save_step
        next_metric = next_artifact = self.global_step
        last: Dict[str, float] = {}
        for epoch in range(epochs):
            t0 = t = time.perf_counter()
            images, steps, loader_s, artifact_s = 0, 0, 0.0, 0.0
            for index, batch in enumerate(dataloader):
                batch = self.batch_to_device(batch)
                loader_s += time.perf_counter() - t
                self.state, metrics = self.train_step(self.state, batch, self.generator)
                self.global_step += 1
                steps += 1
                images += batch.shape[0]
                if self.global_step >= next_metric:
                    next_metric = self.global_step + metric_every
                    last = {k: float(v) for k, v in metrics.items()}
                    self.metrics.write(self.global_step, last)
                if self.global_step >= next_artifact:
                    next_artifact = self.global_step + artifact_every
                    ta = time.perf_counter()
                    self.log_artifacts(batch, epoch, index)
                    artifact_s += time.perf_counter() - ta
                if self.debug and index >= 1:
                    break
                t = time.perf_counter()
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
        os.makedirs(self.save_ckpt_dir, exist_ok=True)
        path = os.path.join(self.save_ckpt_dir, f"step_{self.global_step:08d}.pth")
        torch.save({**self.checkpoint_tree(), "epoch": epoch}, path + ".tmp")
        os.replace(path + ".tmp", path)
        for old in sorted(glob.glob(os.path.join(self.save_ckpt_dir, "step_*.pth")))[
                :-self.keep_checkpoints]:
            os.remove(old)
        self.logger.info("checkpoint %s", path)
        return path

    def checkpoint_tree(self) -> Dict[str, Any]:
        raise NotImplementedError

    def load_checkpoint_tree(self, tree: Dict[str, Any]) -> None:
        raise NotImplementedError

    def log_artifacts(self, batch: torch.Tensor, epoch: int, index: int) -> None:
        """Every ``save_step`` steps; default: nothing."""

"""Run directories, logging, the artifact cadence and the metric writer
(counterpart of the JAX ``utils/experiment.py``)."""

from __future__ import annotations

import json
import logging
import os
import shutil
import time
from typing import Dict, Optional


def create_run_dir(log_dir: str, dataset_name: str, model_name: str,
                   config_path: Optional[str] = None) -> str:
    """A new ``<log_dir>/<dataset>/<model>/run_<time>`` (``_1``, ``_2``, ...
    added when a run of the same second has it), with a copy of the config."""
    ts = time.strftime("%Y-%m-%d-%H-%M-%S")
    base = run_dir = os.path.join(log_dir, dataset_name, model_name, f"run_{ts}")
    n = 0
    while os.path.exists(run_dir):
        n += 1
        run_dir = f"{base}_{n}"
    os.makedirs(run_dir)
    if config_path and os.path.exists(config_path):
        shutil.copy(config_path, os.path.join(run_dir, os.path.basename(config_path)))
    return run_dir


def setup_logging(run_dir: str, name: str = "vqgd_torch") -> logging.Logger:
    logger = logging.getLogger(name)
    logger.setLevel(logging.INFO)
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    fmt = logging.Formatter("%(asctime)s %(levelname)s %(message)s")
    fh = logging.FileHandler(os.path.join(run_dir, "info.log"))
    fh.setFormatter(fmt)
    sh = logging.StreamHandler()
    sh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(sh)
    return logger


def adaptive_save_step(num_batches: int) -> int:
    """Steps between artifacts, scaled with the epoch's length (reference
    vqganVqvaeWorker.py:121-136)."""
    if num_batches > 1000:
        return 500
    if num_batches > 500:
        return 250
    if num_batches > 100:
        return 50
    if num_batches > 10:
        return 5
    return 2


class MetricWriter:
    """``metrics.jsonl`` in the run dir, one ``{"step": ..., **metrics}``
    line a call, written and flushed before the call returns; and, as the
    JAX writer, the same scalars as TensorBoard events under ``tb/`` when
    ``tensorboardX`` imports and ``VQGD_NO_TB`` is unset (the card
    machine's packages need not hold it: then jsonl only). Whether ``tb/``
    is written is logged once, at info level."""

    def __init__(self, run_dir: str, logger: Optional[logging.Logger] = None):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._f = open(self.path, "a")
        self._tb = None
        why = "VQGD_NO_TB is set"
        if not os.environ.get("VQGD_NO_TB"):
            try:
                from tensorboardX import SummaryWriter
                self._tb = SummaryWriter(os.path.join(run_dir, "tb"))
            except Exception as e:  # not installed, or unusable: jsonl only
                why = f"tensorboardX unavailable ({type(e).__name__})"
        (logger or logging.getLogger("vqgd_torch")).info(
            "TensorBoard events: %s", os.path.join(run_dir, "tb") if self._tb else f"off, {why}")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        row = {k: float(v) for k, v in metrics.items()}
        self._f.write(json.dumps({"step": int(step), **row}) + "\n")
        self._f.flush()
        if self._tb is not None:
            for k, v in row.items():
                self._tb.add_scalar(k, v, int(step))
            self._tb.flush()

    def close(self) -> None:
        self._f.close()
        if self._tb is not None:
            self._tb.close()

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

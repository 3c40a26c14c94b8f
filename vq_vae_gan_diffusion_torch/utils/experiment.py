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
    ts = time.strftime("%Y-%m-%d-%H-%M-%S")
    run_dir = os.path.join(log_dir, dataset_name, model_name, f"run_{ts}")
    os.makedirs(run_dir, exist_ok=True)
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
    line a call, written and flushed before the call returns."""

    def __init__(self, run_dir: str):
        os.makedirs(run_dir, exist_ok=True)
        self.path = os.path.join(run_dir, "metrics.jsonl")
        self._f = open(self.path, "a")

    def write(self, step: int, metrics: Dict[str, float]) -> None:
        self._f.write(json.dumps({"step": int(step), **{k: float(v) for k, v in
                                                        metrics.items()}}) + "\n")
        self._f.flush()

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "MetricWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

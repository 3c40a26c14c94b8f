"""Run directories and logging (counterpart of the JAX ``utils/experiment.py``)."""

from __future__ import annotations

import logging
import os
import shutil
import time
from typing import Optional


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

"""The checkpoints the port's serving workers read.

Three forms, all files written by ``torch.save``:

- the port's own bundle, ``{"vqvae": state_dict, "gpt" | "unet": state_dict}``
  (either part may be left out);
- a training checkpoint of the port, ``{"state": {"vqvae": ..., ...},
  "step", "epoch"}``: stage 1's (``"disc"``, ``"opt_g"``, ...), the GPT
  prior's (``"gpt"``, ``"opt"``) or the diffusion prior's (``"unet"``,
  ``"ema"``, ``"opt"``), of which the serving workers read the VQVAE and the
  prior: the GPT, or the U-Net's EMA copy with its statistics, the weights
  the JAX worker samples with;
- a bare ``state_dict`` of one module, as ``tools/export_torch_checkpoint.py``
  writes it from an Orbax checkpoint of the JAX package: the VQVAE
  (``vqvae``/``vqgan``), the minGPT prior (``*_transformer``) or the
  ShuffleNet U-Net denoiser (``vqdiffusion``; with ``--ema``, the EMA
  weights the JAX worker samples with). Their key names are the ones the
  port's modules use; each module is told by a key only it has.

A path where nothing exists is no checkpoint: the caller warns and keeps
its seeded weights. A path that exists but is a directory (an Orbax
checkpoint) or a file of no known form raises, naming the export tool.
"""

from __future__ import annotations

import logging
import os
import pickle
from typing import Dict, Optional

import torch
from torch import nn

EXPORT_TOOL = "tools/export_torch_checkpoint.py"
# the key that tells each module's bare state_dict from the others
_MARKERS = {"vqvae": "codebook.codebook.weight", "gpt": "tok_emb.weight",
            "unet": "init_conv.module.0.weight"}

State = Dict[str, torch.Tensor]


def _refuse(path: str, why: str) -> ValueError:
    return ValueError(
        f"checkpoint {path} {why}. The port reads a torch.save file: its own bundle "
        "{'vqvae': ..., 'gpt' | 'unet': ...}, its training checkpoint, or a bare "
        f"VQVAE, minGPT or ShuffleNet denoiser state_dict. Convert an Orbax checkpoint directory with python {EXPORT_TOOL} "
        "--config <yml> --ckpt <dir> --out <file>.pth (add --ema for a diffusion prior)")


def _is_training(tree) -> bool:
    """True for a training checkpoint of the port (stage 1's or a prior's)."""
    return (isinstance(tree, dict) and {"state", "step", "epoch"} <= set(tree)
            and isinstance(tree["state"], dict) and isinstance(tree["state"].get("vqvae"), dict))


def _prior_of(tree: dict) -> Optional[str]:
    """The prior a training checkpoint trains (``gpt``, ``unet``), None for stage 1."""
    return next((kind for kind in ("gpt", "unet") if kind in tree["state"]), None)


def read_training_checkpoint(path: str, prior: Optional[str] = None) -> Optional[dict]:
    """The port's training checkpoint at ``path`` whole (optimizers, step,
    EMA too) when it trains ``prior`` (``gpt``, ``unet``; None: stage 1),
    or None where ``path`` holds nothing or another form."""
    if not os.path.isfile(path):
        return None
    tree = _load(path)
    return tree if _is_training(tree) and _prior_of(tree) == prior else None


def _load(path: str):
    try:
        return torch.load(path, map_location="cpu", weights_only=True)
    except (pickle.UnpicklingError, EOFError, RuntimeError) as e:
        raise _refuse(path, f"is not a torch.save file of tensors ({type(e).__name__}: {e})") from e


def read_checkpoint(path: str) -> Optional[Dict[str, State]]:
    """The module ``state_dict``s of the checkpoint at ``path`` by kind
    (``vqvae``, ``gpt``, ``unet``), or None when nothing exists at ``path``.
    Raises ValueError for a directory or a file of no known form."""
    if not os.path.exists(path):
        return None
    if os.path.isdir(path):
        raise _refuse(path, "is a directory (an Orbax checkpoint?), not a file")
    state = _load(path)
    if not isinstance(state, dict) or not state:
        raise _refuse(path, "holds no dict")
    if all(isinstance(v, torch.Tensor) for v in state.values()):
        kinds = [kind for kind, key in _MARKERS.items() if key in state]
        if len(kinds) != 1:
            raise _refuse(path, "is a state_dict of no module the port serves")
        return {kinds[0]: state}
    if _is_training(state):
        trained = state["state"]
        found = {"vqvae": trained["vqvae"]}
        if "gpt" in trained:
            found["gpt"] = trained["gpt"]
        if "ema" in trained:
            found["unet"] = trained["ema"]
        return found
    if set(state) <= set(_MARKERS) and all(isinstance(v, dict) for v in state.values()):
        return dict(state)
    raise _refuse(path, f"has keys {sorted(map(str, state))[:6]} of no known form")


def restore(path: str, modules: Dict[str, nn.Module], logger: logging.Logger,
            what: str) -> bool:
    """Load into ``modules`` (by kind) the parts of the checkpoint at
    ``path`` that name them, each with ``load_state_dict(strict=True)``.
    Returns False after a warning when nothing exists at ``path``; raises as
    :func:`read_checkpoint` does, and when the checkpoint holds none of
    ``modules``. ``what`` names the checkpoint in the log."""
    found = read_checkpoint(path)
    if found is None:
        logger.warning("%s checkpoint %s not found; using fresh init", what, path)
        return False
    parts = [kind for kind in modules if kind in found]
    if not parts:
        raise _refuse(path, f"holds {sorted(found)}, none of {sorted(modules)}")
    for kind in parts:
        modules[kind].load_state_dict(found[kind], strict=True)
    logger.info("%s: restored %s from %s", what, " and ".join(parts), path)
    return True

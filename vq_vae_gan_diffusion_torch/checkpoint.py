"""The checkpoints the port's serving workers read.

Three forms, all files written by ``torch.save``:

- the port's own bundle, ``{"vqvae": state_dict, "gpt" | "unet": state_dict}``
  (either part may be left out), or ``{"vae": state_dict}``;
- a training checkpoint of the port, ``{"state": {...}, "step",
  "epoch"}``: stage 1's (``"vqvae"``, ``"disc"``, ``"opt_g"``, ...), the GPT
  prior's (``"vqvae"``, ``"gpt"``, ``"opt"``), the diffusion prior's
  (``"vqvae"``, ``"unet"``, ``"ema"``, ``"opt"``) or the pixel-space
  ``gaussiandiffusion3d`` worker's (``"unet"``, ``"ema"``, ``"opt"``, no
  VQVAE) or the VAE worker's (``"vae"``, ``"opt"``), of which the serving
  workers read the VQVAE and the prior (the GPT, or the U-Net's EMA copy
  with its statistics, the weights the JAX worker samples with) or the VAE;
- a bare ``state_dict`` of one module, as ``tools/export_torch_checkpoint.py``
  writes it from an Orbax checkpoint of the JAX package: the VQVAE
  (``vqvae``/``vqgan``), the minGPT prior (``*_transformer``) or the
  U-Net denoiser, ShuffleNet or Conv1d (``vqdiffusion``,
  ``gaussiandiffusion2d``, ``gaussiandiffusion3d``; with ``--ema``, the EMA
  weights the JAX worker samples with) or the VAE (``vae``, which the
  export tool writes as ``{"vae_state_dict": state_dict}``; the
  reference's own file adds ``"optimizer_state_dict"``, which is left out). Their key names are the ones the port's modules use;
  each module is told by a key only it has.

A path where nothing exists is no checkpoint: the caller warns and keeps
its seeded weights. A path that exists but is a directory (an Orbax
checkpoint) or a file of no known form raises, naming the export tool.

The reference's own training files are read by :func:`reference_parts`, the
port's side of ``tools/import_torch_checkpoint.py``, for
``import_checkpoint.py``, which writes them as a training checkpoint of the
port.
"""

from __future__ import annotations

import glob
import logging
import os
import pickle
from typing import Any, Dict, Optional, Tuple

import torch
from torch import nn

from .config import TRANSFORMER_MODELS, VQ_STAGE1_MODELS

EXPORT_TOOL = "tools/export_torch_checkpoint.py"
# the keys that tell each module's bare state_dict from the others (the
# U-Net's: the ShuffleNet's, the Conv1d U-Net's)
_MARKERS = {"vqvae": ("codebook.codebook.weight",), "gpt": ("tok_emb.weight",),
            "unet": ("init_conv.module.0.weight", "mid_attn.fn.fn.to_qkv.weight"),
            "vae": ("fc_mu.weight",)}

State = Dict[str, torch.Tensor]


def _refuse(path: str, why: str) -> ValueError:
    return ValueError(
        f"checkpoint {path} {why}. The port reads a torch.save file: its own bundle "
        "{'vqvae': ..., 'gpt' | 'unet': ...}, its training checkpoint, or a bare "
        "VQVAE, minGPT, U-Net denoiser or VAE state_dict. Convert an Orbax checkpoint "
        f"directory with python {EXPORT_TOOL} "
        "--config <yml> --ckpt <dir> --out <file>.pth (add --ema for a diffusion prior)")


def _is_training(tree) -> bool:
    """True for a training checkpoint of the port (stage 1's, a prior's, the
    pixel-space worker's or the VAE's)."""
    return (isinstance(tree, dict) and {"state", "step", "epoch"} <= set(tree)
            and isinstance(tree["state"], dict)
            and any(isinstance(tree["state"].get(k), dict) for k in ("vqvae", "unet", "vae")))


def _prior_of(tree: dict) -> Optional[str]:
    """What a training checkpoint trains: ``gpt`` or ``unet`` (a prior over
    a VQVAE's codes), ``pixel`` (the pixel-space U-Net, no VQVAE), ``vae``,
    None for stage 1."""
    if "vae" in tree["state"]:
        return "vae"
    if "vqvae" not in tree["state"]:
        return "pixel"
    return next((kind for kind in ("gpt", "unet") if kind in tree["state"]), None)


def read_training_checkpoint(path: str, prior: Optional[str] = None) -> Optional[dict]:
    """The port's training checkpoint at ``path`` whole (optimizers, step,
    EMA too) when it trains ``prior`` (``gpt``, ``unet``, ``pixel``,
    ``vae``; None: stage 1), or None where ``path`` holds nothing or another form."""
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
    (``vqvae``, ``gpt``, ``unet``, ``vae``), or None when nothing exists at ``path``.
    Raises ValueError for a directory or a file of no known form."""
    if not os.path.exists(path):
        return None
    if os.path.isdir(path):
        raise _refuse(path, "is a directory (an Orbax checkpoint?), not a file")
    state = _load(path)
    if not isinstance(state, dict) or not state:
        raise _refuse(path, "holds no dict")
    if isinstance(state.get("vae_state_dict"), dict):
        # the reference's {"vae_state_dict", "optimizer_state_dict"}: the VAE alone,
        # as tools/import_torch_checkpoint.py reads it
        state = state["vae_state_dict"]
    if all(isinstance(v, torch.Tensor) for v in state.values()):
        kinds = [kind for kind, keys in _MARKERS.items() if any(k in state for k in keys)]
        if len(kinds) != 1:
            raise _refuse(path, "is a state_dict of no module the port serves")
        return {kinds[0]: state}
    if _is_training(state):
        trained = state["state"]
        found = {k: trained[k] for k in ("vqvae", "vae") if k in trained}
        if "gpt" in trained:
            found["gpt"] = trained["gpt"]
        if "ema" in trained:
            found["unet"] = trained["ema"]
        return found
    if set(state) <= set(_MARKERS) and all(isinstance(v, dict) for v in state.values()):
        return dict(state)
    raise _refuse(path, f"has keys {sorted(map(str, state))[:6]} of no known form")


def write_checkpoint(directory: str, step: int, tree: Dict[str, object], keep: int = 3) -> str:
    """``torch.save(tree)`` to ``<directory>/step_<step>.pth`` through a
    ``.tmp`` file and ``os.replace``, then remove all but the newest
    ``keep`` ``step_*.pth`` files there (Orbax's ``max_to_keep``); returns
    the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"step_{step:08d}.pth")
    torch.save(tree, path + ".tmp")
    os.replace(path + ".tmp", path)
    for old in sorted(glob.glob(os.path.join(directory, "step_*.pth")))[:-keep]:
        os.remove(old)
    return path


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


# -- the reference's training files ---------------------------------------------------------

#: the schedule buffers the reference's discrete diffusion registers, which
#: the port recomputes from the config (the JAX package's
#: ``utils/torch_import._DISCRETE_SCHEDULE_BUFFERS``)
DISCRETE_SCHEDULE_BUFFERS = (
    "log_at", "log_bt", "log_ct", "log_cumprod_at", "log_cumprod_bt",
    "log_cumprod_ct", "log_1_min_ct", "log_1_min_cumprod_ct",
    "zero_vector", "prior_ps", "prior_weight",
)


def strip_prefix(state: State, prefix: str) -> State:
    """The entries of ``state`` under ``prefix``, with it taken off; the rest
    is dropped."""
    return {k[len(prefix):]: v for k, v in state.items() if k.startswith(prefix)}


def unwrap_ema(state: State) -> State:
    """An EMA wrapper's ``state_dict`` -> the averaged module's: ema_pytorch's
    ``ema_model.*`` (its ``online_model.*``, ``initted`` and ``step``
    dropped), torch's ``AveragedModel``'s ``module.*`` (its ``n_averaged``
    dropped); any other dict as it is."""
    for prefix in ("ema_model.", "module."):
        if any(k.startswith(prefix) for k in state):
            return strip_prefix(state, prefix)
    return state


def denoiser_kind(state: State) -> str:
    """``shuffle`` for the ShuffleNet U-Net's keys, else ``unet1d`` (the two
    denoisers the reference's diffusion wrappers hold)."""
    return "shuffle" if any(k.startswith("encoder_blocks.") for k in state) else "unet1d"


def discrete_diffusion_parts(state: State) -> Tuple[State, torch.Tensor, torch.Tensor]:
    """The reference's discrete diffusion ``state_dict`` -> (the denoiser
    under ``model.``, ``Lt_history``, ``Lt_count``); its schedule buffers
    are dropped. Raises where the Lt buffers are missing or another buffer
    is there, as ``torch_import.convert_discrete_diffusion`` does."""
    rest = {k: v for k, v in state.items() if not k.startswith("model.")}
    lt_history, lt_count = rest.pop("Lt_history", None), rest.pop("Lt_count", None)
    if lt_history is None or lt_count is None:
        raise ValueError("diffusion state_dict lacks Lt_history/Lt_count buffers: not a "
                         "reference vq-diffusion checkpoint?")
    unknown = [k for k in rest if k not in DISCRETE_SCHEDULE_BUFFERS]
    if unknown:
        raise ValueError(f"unrecognized diffusion buffers: {unknown}")
    return strip_prefix(state, "model."), lt_history, lt_count


def reference_parts(raw: Dict[str, Any], family: str) -> Dict[str, Any]:
    """The parts of a reference training file ``raw`` of ``family``, as
    ``tools/import_torch_checkpoint.py`` takes them, by the port's names:

    - ``vqvae`` / ``vqgan``: the bare VQVAE ``state_dict`` -> ``vqvae``;
    - ``vae``: ``{"vae_state_dict", ...}`` or a bare one -> ``vae``;
    - ``*_transformer``: the bare minGPT ``state_dict`` -> ``gpt``;
    - ``vqdiffusion``: ``{"diffusion", "optimizer", "scheduler"[,
      "model_ema"]}`` (or the diffusion alone) -> ``unet`` and ``ema`` (the
      EMA wrapper's, else the online denoiser) and ``lt`` (``Lt_history``,
      ``Lt_count``), every file through :func:`discrete_diffusion_parts`;
    - ``gaussiandiffusion2d`` / ``gaussiandiffusion3d``: ``{"model", "opt",
      "ema", ...}`` or ``{"model", "model_ema"}`` -> the denoisers under
      ``model.`` as ``unet`` and ``ema``, the diffusion's buffers dropped.

    Raises for a family the reference saves no file for."""
    if family in VQ_STAGE1_MODELS:
        return {"vqvae": raw}
    if family == "vae":
        return {"vae": raw.get("vae_state_dict", raw)}
    if family in TRANSFORMER_MODELS:
        return {"gpt": raw}
    if family == "vqdiffusion":
        unet, lt_history, lt_count = discrete_diffusion_parts(raw.get("diffusion", raw))
        ema = unet
        if "model_ema" in raw:
            ema, _, _ = discrete_diffusion_parts(unwrap_ema(raw["model_ema"]))
        return {"unet": unet, "ema": ema, "lt": (lt_history, lt_count)}
    if family in ("gaussiandiffusion2d", "gaussiandiffusion3d"):
        unet = strip_prefix(raw.get("model", raw), "model.")
        ema_sd = raw.get("ema") or raw.get("model_ema")
        ema = unet if ema_sd is None else strip_prefix(unwrap_ema(ema_sd), "model.")
        return {"unet": unet, "ema": ema}
    raise ValueError(f"unsupported family {family!r}: the reference has no checkpoint "
                     "format for it")

"""Config system.

Parses the reference's YAML schema (reference: ``configs/training_config_small.yml``,
consumed as raw nested dicts all over the reference, e.g. ``train.py:353-354``,
``network/vqvae/vqvae.py:44-55``) into a validated, attribute-accessible tree.

Deliberate fixes over the reference (each documented in SURVEY.md §5):

- YAML ``None`` written as the *string* ``"None"`` (training_config_small.yml:12)
  is normalized to real ``None`` here.
- ``latent_channels`` being silently reused as the token *sequence length*
  (vqganVqvaeWorker.py:65) worked only because ``16**2 == 256``. We expose an
  explicit ``seq_len = latent_size ** 2`` helper instead.
- dataset/model-keyed tables (``img_size[dataset]``, ``batch_size[model][dataset]``)
  are kept schema-compatible, with ``resolve_*`` helpers.
"""

from __future__ import annotations

import copy
from typing import Any, Iterator, Mapping

import yaml

_NONE_STRINGS = {"None", "none", "null", "~", ""}


class Config(Mapping):
    """Immutable-ish nested dict with attribute access: ``cfg.architecture.vqvae.latent_size``."""

    def __init__(self, data: dict):
        object.__setattr__(self, "_data", dict(data))

    # -- mapping protocol -------------------------------------------------
    def __getitem__(self, key: str) -> Any:
        val = self._data[key]
        return Config(val) if isinstance(val, dict) else val

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    # -- attribute access --------------------------------------------------
    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as e:
            raise AttributeError(f"config has no key {key!r}; available: {list(self._data)}") from e

    def __setattr__(self, key: str, value: Any) -> None:
        raise AttributeError("Config is read-only")

    def get(self, key: str, default: Any = None) -> Any:
        if key in self._data:
            return self[key]
        return default

    def to_dict(self) -> dict:
        return copy.deepcopy(self._data)

    def replace_path(self, path: str, value: Any) -> "Config":
        """A copy with a dotted path overridden, e.g.
        ``cfg.replace_path('architecture.vqdiffusion.fused_sampler', False)``."""
        data = self.to_dict()
        node = data
        keys = path.split(".")
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = value
        return Config(data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"


def _normalize(node: Any) -> Any:
    """Recursively fix YAML quirks: 'None'-strings → None, '(a, b)' tuples → tuple."""
    if isinstance(node, dict):
        return {k: _normalize(v) for k, v in node.items()}
    if isinstance(node, list):
        return [_normalize(v) for v in node]
    if isinstance(node, str):
        s = node.strip()
        if s in _NONE_STRINGS:
            return None
        # reference writes adam betas as the string "(0.65, 0.95)"
        # (training_config_small.yml gaussiandiffusion2d.adam_betas)
        if s.startswith("(") and s.endswith(")"):
            try:
                return tuple(float(x) for x in s[1:-1].split(","))
            except ValueError:
                return node
        if s == "inf":
            return float("inf")
    return node


def load_config(path: str) -> Config:
    with open(path, "r") as f:
        raw = yaml.safe_load(f)
    return Config(_normalize(raw))


def config_from_dict(data: dict) -> Config:
    return Config(_normalize(data))


# ---------------------------------------------------------------------------
# Schema-aware helpers (reference look-up idioms, made explicit).
# ---------------------------------------------------------------------------

# model_name aliases: the reference treats vqgan/vqvae as one worker and
# vqgan_transformer/vqvae_transformer as one (train.py:90-175).
VQ_STAGE1_MODELS = ("vqvae", "vqgan")
TRANSFORMER_MODELS = ("vqvae_transformer", "vqgan_transformer")
CONTINUOUS_MODELS = ("c_vqdiffusion", "v_vqdiffusion")
ALL_MODELS = VQ_STAGE1_MODELS + TRANSFORMER_MODELS + CONTINUOUS_MODELS + (
    "vqdiffusion",
    "gaussiandiffusion2d",
    "gaussiandiffusion3d",
    "vae",
)


def resolve_img_size(cfg: Config) -> int:
    ds = cfg.dataset.dataset_name
    return int(cfg.dataset.img_size[ds])


def resolve_img_channels(cfg: Config) -> int:
    ds = cfg.dataset.dataset_name
    return int(cfg.dataset.img_channels[ds])


def resolve_batch_size(cfg: Config, model_name: str | None = None) -> int:
    """batch_size[model][dataset] (reference build_dataloader.py:30-35);
    models the table does not name read the ``vqvae`` row."""
    ds = cfg.dataset.dataset_name
    model = model_name or cfg.architecture.model_name
    table = cfg.dataset.batch_size
    if model not in table:
        model = "vqgan_transformer" if model in TRANSFORMER_MODELS else "vqvae"
    return int(table[model][ds])


def seq_len(cfg: Config) -> int:
    """Token sequence length of the stage-1 latent grid: latent_size².

    The reference conflated this with ``latent_channels`` (vqganVqvaeWorker.py:65,
    vqDiffusion.py:28); we compute it explicitly.
    """
    return int(cfg.architecture.vqvae.latent_size) ** 2


def validate(cfg: Config) -> None:
    """Fail-fast checks run by every entry point."""
    arch = cfg.architecture
    if arch.model_name not in ALL_MODELS:
        raise ValueError(f"unknown model_name {arch.model_name!r}; expected one of {ALL_MODELS}")
    ds = cfg.dataset.dataset_name
    if ds not in cfg.dataset.img_size:
        raise ValueError(f"dataset {ds!r} missing from img_size table")
    vq = arch.vqvae
    n_down = len(list(vq.intermediate_channels)) - 1
    expected_latent = resolve_img_size(cfg) // (2 ** n_down)
    if int(vq.latent_size) != expected_latent:
        # the reference never validated this; mismatches silently break stage-2
        # reshape logic (vqTransformer.py:83-103). We warn loudly instead.
        import logging

        logging.getLogger(__name__).warning(
            "latent_size=%s but img_size %s with %s downsamples gives %s; "
            "stage-2 models will use the actual encoder output size.",
            vq.latent_size, resolve_img_size(cfg), n_down, expected_latent,
        )


# The command-line values of the root CLIs' --fused-sampler and
# --fused-posterior. on/off become True/False; the others (the JAX package's
# TPU modes) are written as given, and every truthy value selects the CUDA
# kernels where the config is read (``shuffle_infer``, ``posterior_mode``).
FUSED_SAMPLER_CHOICES = ("on", "off", "pallas", "packed")
FUSED_POSTERIOR_CHOICES = ("on", "off", "interpret", "prng")


def flag_value(flag: str) -> Any:
    """A CLI's fused-route flag as the config stores it."""
    return {"on": True, "off": False}.get(flag, flag)


def apply_fused_flags(cfg: Config, fused_sampler: str | None = None,
                      fused_posterior: str | None = None) -> Config:
    """``cfg`` with the root ``train.py``'s and ``generate.py``'s overrides:
    ``fused_sampler`` into ``trainer.{gaussiandiffusion3d,vqdiffusion}``
    where the config has them and into ``architecture.vqdiffusion``;
    ``fused_posterior`` into ``architecture.vqdiffusion`` where it exists."""
    if fused_sampler is not None:
        val = flag_value(fused_sampler)
        for fam in ("gaussiandiffusion3d", "vqdiffusion"):
            if fam in cfg.trainer:
                cfg = cfg.replace_path(f"trainer.{fam}.fused_sampler", val)
        if "vqdiffusion" in cfg.architecture:
            cfg = cfg.replace_path("architecture.vqdiffusion.fused_sampler", val)
    if fused_posterior is not None and "vqdiffusion" in cfg.architecture:
        cfg = cfg.replace_path("architecture.vqdiffusion.fused_posterior",
                               flag_value(fused_posterior))
    return cfg

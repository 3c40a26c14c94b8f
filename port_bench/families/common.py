"""What the families share: the port's configuration tree from a
benchmark configuration, the images the cells feed, and the comparisons."""

from __future__ import annotations

import tempfile
from typing import Dict, List, Optional, Tuple

import torch

from ..weights import generator

Reading = Tuple[str, Optional[float]]   # None: nothing came to judge


def dataset_tree(cfg: dict, model: str) -> dict:
    ds = "Oxford102Flower"
    return {"dataset_name": ds, "mean": cfg["mean"], "std": cfg["std"],
            "img_channels": {ds: cfg["img_channels"]}, "img_size": {ds: cfg["img_size"]},
            "batch_size": {model: {ds: cfg["batch_size"]}}}


def images(cfg: dict, n: int, device, seed: int, *tags) -> torch.Tensor:
    """n synthetic images [n, H, W, C], uniform in [0, 1] and normalised by
    the dataset's mean and std as the loaders do; drawn on the device."""
    g = generator(device, seed, "images", *tags)
    s, c = cfg["img_size"], cfg["img_channels"]
    x = torch.rand((n, s, s, c), generator=g, device=device)
    mean = torch.tensor(cfg["mean"], device=device)
    std = torch.tensor(cfg["std"], device=device)
    return (x - mean) / std


def run_dir() -> str:
    """Where a worker would write artifacts; the benchmark writes none."""
    return tempfile.gettempdir()


def relative_image_error(images: torch.Tensor, ref: torch.Tensor) -> float:
    """max |images - ref| over max |ref|."""
    return float((images.float() - ref).abs().max() / ref.abs().max())


def leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
             names: List[str]) -> Tuple[float, str]:
    """The worst leaf's |prog - ref| over max(ref's norm of the leaf, ref's
    median leaf norm), over ``names``; returns (gap, leaf)."""
    vals = sorted(ref.values())
    median = vals[len(vals) // 2]
    worst, leaf = 0.0, ""
    for n in names:
        gap = abs(prog[n] - ref[n]) / max(ref[n], median, 1e-30)
        if gap >= worst:
            worst, leaf = gap, n
    return worst, leaf


def moving_leaves(grad_ref: Dict[str, float]) -> List[str]:
    """The leaves whose reference gradient is at least a thousandth of the
    median leaf's: the others (a bias that a following normalisation or
    softmax cancels) move under Adam by round-off alone."""
    vals = sorted(grad_ref.values())
    median = vals[len(vals) // 2]
    return [n for n, v in grad_ref.items() if v >= 1e-3 * median]


def training_readings(prog: dict, ref: dict) -> List[Reading]:
    """The numbers a training cell compares, from the program's record and
    the reference's of the same first steps: each step's loss, the first
    gradient by leaf, the parameters' change after the steps by leaf (and
    the EMA's, where there is one)."""
    loss = max(abs(a - b) / abs(b) for a, b in zip(prog["losses"], ref["losses"]))
    grad, _ = leaf_gap(prog["grad"], ref["grad"], list(ref["grad"]))
    moving = moving_leaves(ref["grad"])
    change, _ = leaf_gap(prog["delta"], ref["delta"], moving)
    out = [("loss_gap", loss), ("grad_gap", grad), ("change_gap", change)]
    if ref.get("ema_delta"):
        ema, _ = leaf_gap(prog["ema_delta"], ref["ema_delta"], moving)
        out.append(("ema_change_gap", ema))
    return out

"""The traffic kinds. A traffic file's ``kind`` names the file
``loops/<kind>.py`` that drives it; the file's ``run`` takes

    run(fam, cfg, traffic, seed, seconds, trace, device, setup_started, chips)

builds the family's side (set-up), warms up the cell's own shapes,
measures for the given seconds, keeps what the check needs, and in a
traced run profiles a short steady stretch inside its window. ``chips`` is
the cell's own count: a kind that runs in this one process drives one
card, and a kind for more cards starts and stops its ranks itself. Its
result may carry ``device`` (``count``, ``memory_peak_bytes``, ``busy_s``)
read over those ranks, which the result line then takes as it is.

A new kind is a new file here, found by its name; no file of the harness
changes.
"""

from __future__ import annotations

import time

import torch


class Clock:
    """Host clock with the device synchronised where asked."""

    def __init__(self, device: torch.device):
        self.device = device

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def now(self, sync: bool = False) -> float:
        if sync:
            self.sync()
        return time.perf_counter()


def one_card(kind: str, chips: int) -> None:
    """Refuse a cell on more cards for a kind that drives one."""
    if chips != 1:
        raise ValueError(f"the traffic kind {kind} drives one card in this process; a cell on "
                         f"{chips} cards needs a kind that starts its ranks")

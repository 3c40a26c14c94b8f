"""On the card, at each cell's own size: the program's readings on three
seeds keep to their limits, and the control (the plain reference in TF32,
the nearest precision below the configurations' float32, put in the
program's place) fails its numbers on each seed: in a serving cell every
number, since each needs an upper reading of its own; in a training cell
at least one, as does half of the batch left out. Run on the chip with
``python3 -m pytest port_bench/tests -m card -rA`` (the readings print
among the passes); skips elsewhere."""

import pytest

from port_bench.calibrate import readings
from port_bench.run import Bench

SEEDS = (4100000001, 4100000002, 4100000003)
CELLS = ["gpt.serve", "gaussian3d.serve", "gpt.train", "gaussian3d.train"]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_and_the_faults_fail_and_the_program_passes(card, cell):
    bench = Bench()
    limits = bench.config(bench.cell(cell)["config"])["limits"]
    seconds = 16.0 if cell == "gpt.serve" else 1.0
    for seed in SEEDS:
        got = readings(bench, cell, seed, seconds, True, None)
        print(cell, seed, got)      # kept in the report's passes with -rA
        assert all(got["sound"][k] <= limits[k] for k in limits if k in got["sound"]), got
        failed = [got["control"][k] > limits[k] for k in limits if k in got["control"]]
        assert failed and (all(failed) if cell.endswith(".serve") else any(failed)), got
        if cell.endswith(".train"):
            bad = readings(bench, cell, seed, seconds, False, "half_batch")["half_batch"]
            print(cell, seed, "half_batch", bad)
            assert any(bad[k] > limits[k] for k in limits if k in bad), bad

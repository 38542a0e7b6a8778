"""On the card, at each cell's own size: the program's readings pass the
cell's limits, and those of the control (the reference computed in float8,
one step below the configuration's bfloat16, in the program's place) fail
at least one of them, on three seeds."""

import pytest

from benchmark.lib import harness as H
from benchmark.tools.readings import readings

CELLS = [w["name"] for w in H.load_json(H.ROOT, "BENCHMARK.json")[
    "workloads"]]
SEEDS = (2**31 + 901, 2**31 + 902, 2**31 + 903)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    limits = H.load_cell(cell)[1]["limits"]
    rows = readings(cell, SEEDS, 2.0, True, device=card, log=lambda s: None)
    for r in rows:
        over = {k for k, v in r["readings"].items() if v > limits[k]}
        if r["side"] == "program":
            assert not over, (r["seed"], over)
        else:
            assert over, r["seed"]

"""On the card, at each cell's own size: the control fails the cell's
limit on three seeds and the program keeps within it.
`python -m pytest ptbench/tests -m card` (several minutes)."""

import pytest

from ptbench import calibrate
from ptbench import run as R

from ._tiny import bench

STEPS = {"pt1080-sponza": 255, "pt1080-sponza-alpha": 218,
         "bake4096-sponza": 30}


@pytest.mark.card
@pytest.mark.parametrize("cell", sorted(STEPS))
def test_control_fails_and_program_passes_at_cell_size(cell, card):
    c = R.find_cell(bench(), cell)
    config, traffic = R.load_config(c["config"]), R.load_traffic(c["traffic"])
    limits = R.load_limits(cell)
    from ptbench.check import verdict
    for line in calibrate.readings(config, traffic, [2**31 + 11],
                                   [2**31 + 12, 2**31 + 13, 2**31 + 14],
                                   STEPS[cell], card):
        ok = verdict(line["numbers"], limits)
        assert ok == (line["kind"] == "program"), line

"""On the card, at each cell's own size: the program's first steps pass the
cell's limits, and the control (the plain reference put in the program's
place, its products in TF32, the precision just below the configuration's
f32) fails them. About a minute and a half a cell:

    PYTHONPATH=src python3 -m pytest -q perfbench/tests -m card
"""

import pytest

from perfbench import check, harness, traffic
from perfbench.kinds import train
from perfbench.reference.train import follow
from perfbench.tests import small

CELLS = [c["name"] for c in small.bench()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_program_passes_and_control_fails(cell, card):
    spec = harness.cell_of(small.bench(), cell)
    conf, mix = harness.load_config(spec["config"]), traffic.load(spec["traffic"])
    limits = check.load_limits(cell, train.NUMBERS)
    seed = 3_000_000_777
    trainer, program, _ = train.start(conf, mix, seed, card)
    del trainer
    train.free(card)
    reference = follow(conf, mix, seed, card)
    assert check.judge(train.gaps(program, reference), limits)
    control = follow(conf, mix, seed, card, tf32=True)
    assert not check.judge(train.gaps(control, reference), limits)

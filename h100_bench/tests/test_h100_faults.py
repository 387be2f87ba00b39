"""A whole run on the CPU with the timed path broken underneath
(``h100_bench/faults.py``): the check has to come out not correct. The
look for a card is skipped; the cell's own limits judge."""

import pytest

from h100_bench import faults, harness
from h100_bench.tests import smoke

CASES = [("mamba2_370m.train", "unchanged"),
         ("mamba2_370m.train", "half_batch")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault):
    f, pc = smoke.files(cell, **smoke.TRAIN)
    with faults.FAULTS[fault]():
        line = harness.run_cell(cell, 2 ** 31 + 5, 0.3, False, device="cpu",
                                files=f, port_cfg=pc)
    assert not line["correct"], line["checks"]

"""On the card, at each cell's own size: the program passes its cell's
check, and the control (the reference in fp8 in the program's place)
fails it. Run on a machine with an H100:

    python -m pytest -q -m gpu h100_bench/tests/test_h100_control.py
"""

import pytest

from h100_bench import harness

CELLS = [w["name"] for w in harness.benchmark()["workloads"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_where_the_program_passes(cell, cuda):
    harness.cache_environment()
    limits = harness.cell_files(cell)["cell"]["limits"]
    for seed in (2 ** 31 + 101, 2 ** 31 + 211, 2 ** 31 + 307):
        line = harness.run_cell(cell, seed, 0.0, False, control=True)
        assert line["correct"], (seed, line["checks"])
        passed, numbers = harness.judge(line["control"], limits)
        assert not passed, (seed, numbers)

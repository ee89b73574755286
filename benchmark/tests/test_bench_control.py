"""On the card: the control, the reference computed with TF32 products in the
program's place, comes out not correct against each cell's limits, and so
does, in a projection cell, the reference with TF32 products in its backward
to the input alone; the program, at the same size, comes out correct.

    python -m pytest benchmark/tests -m card      # on a machine with a CUDA device

The sizes are cut so that a test run holds them; the limits were set from
readings at each cell's own size (``calibrate.py``, ``PERF.md``).
"""

import pytest

from benchmark import calibrate, manifest

BENCH = manifest.load()
CELLS = [w["name"] for w in BENCH["workloads"]]
SMALL = {"project": dict(batch=2048, pool=2, check_poses=1024),
         "score": dict(batch=16384, pool=2, check_poses=8192),
         "train": dict(noisy=5000, manifold=5000)}


def _readings(cell: str, who: str, seed: int) -> tuple:
    mix = manifest.traffic(manifest.cell(BENCH, cell)["traffic"])
    mix.update(SMALL[mix["kind"]])
    return calibrate.readings(BENCH, cell, seed, who, "cuda", mix)["numbers"], manifest.limits(cell)


CONTROLS = [(c, "control") for c in CELLS] + [
    (c, "control:backward") for c in CELLS
    if manifest.traffic(manifest.cell(BENCH, c)["traffic"])["kind"] == "project"]


@pytest.mark.card
@pytest.mark.parametrize("cell,who", CONTROLS)
def test_the_control_is_not_correct(card, cell, who):
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        numbers, limits = _readings(cell, who, seed)
        assert any(numbers[k] > v for k, v in limits.items()), (seed, numbers)


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_the_program_is_correct(card, cell):
    numbers, limits = _readings(cell, "program", 2**31 + 104)
    assert all(numbers[k] <= v for k, v in limits.items()), numbers

"""The port's ``launch/cells.py`` against the reference's: the runnable
cells, the overrides' keys, and ``perf_for`` of every runnable cell at
data widths 16 (one pod) and 32 (two), field by field."""
import dataclasses

import pytest

from repro.launch import cells as jcells
from repro_torch.launch import cells


def test_runnable_cells_match_reference():
    got = cells.runnable_cells()
    assert got == jcells.runnable_cells()
    assert len(got) == len(set(got)) > 0
    # the full-attention archs skip long_500k
    assert ("stablelm-1.6b", "long_500k") not in got
    assert ("zamba2-1.2b", "long_500k") in got


def test_overrides_and_data_axis_match_reference():
    assert cells.DATA_AXIS == jcells.DATA_AXIS == 16
    assert sorted(cells.PERF_OVERRIDES) == sorted(jcells.PERF_OVERRIDES)
    for key, perf in cells.PERF_OVERRIDES.items():
        assert dataclasses.asdict(perf) == \
            dataclasses.asdict(jcells.PERF_OVERRIDES[key]), key


@pytest.mark.parametrize("width", [16, 32])
@pytest.mark.parametrize("arch,shape", jcells.runnable_cells())
def test_perf_for_matches_reference(arch, shape, width):
    got = cells.perf_for(arch, shape, width)
    want = jcells.perf_for(arch, shape, width)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)

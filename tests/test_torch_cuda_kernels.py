"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on the card.

Every test here is marked ``cuda`` and skips without a card.  This file
imports neither JAX nor the reference package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda_kernels.py
"""
import numpy as np
import pytest
import torch

from repro_torch import interop
from repro_torch.core import arith, isa
from repro_torch.core.bitplane import Field
from repro_torch.core.engine import PassSchedule, bucket_schedule
from repro_torch.kernels.ap_match import ops as ap_ops
from repro_torch.kernels.thermal_stencil import ops as st_ops

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(7, 36, 36), (6, 7, 36, 36),
                                   (7, 40, 24), (2, 3, 5, 33)])
def test_stencil_kernel_equals_plain(cuda, shape):
    """The kernel repeats the plain version's arithmetic bit for bit
    (terms in the same order, built with -fmad=false)."""
    rng = np.random.default_rng(sum(shape))
    T = torch.from_numpy(rng.uniform(45, 75, shape).astype(np.float32))
    F = {k: torch.from_numpy(rng.uniform(0, 1e-2, shape).astype(np.float32))
         for k in st_ops.FIELD_KEYS}
    T, F = T.to(cuda), {k: v.to(cuda) for k, v in F.items()}
    before = st_ops.apply_operator_fields.launches
    y = st_ops.apply_operator_fields(T, F)
    assert st_ops.apply_operator_fields.launches == before + 1
    torch.testing.assert_close(y, st_ops.apply_operator_fields_plain(T, F),
                               rtol=0, atol=0)


def test_stencil_kernel_rejects_what_it_does_not_take(cuda):
    T = torch.zeros((3, 8, 8), device=cuda)
    F = {k: torch.zeros((3, 8, 8), device=cuda) for k in st_ops.FIELD_KEYS}
    with pytest.raises(ValueError):
        st_ops.apply_operator_fields(T.double(), F)
    with pytest.raises(ValueError):
        st_ops.apply_operator_fields(T, dict(F, g_pkg=F["g_pkg"].cpu()))


def _schedule(name):
    prod, carry = Field(20, 13), Field(33, 1)
    return {
        "add": lambda: isa.add(Field(0, 8), Field(8, 8), Field(16, 1)),
        "mul": lambda: PassSchedule.concat(arith.mul_schedules(
            Field(0, 6), Field(8, 6), prod, carry)),
        "lut": lambda: isa.lut(Field(0, 4), Field(34, 6),
                               lambda x: (x * x + 3) % 64),
    }[name]()


@pytest.mark.parametrize("n_lanes", [1, 4, 32, 33, 4096])
@pytest.mark.parametrize("name", ["add", "mul", "lut"])
def test_ap_kernel_equals_plain(cuda, name, n_lanes):
    tabs = interop.schedule_from_reference(*bucket_schedule(_schedule(name)),
                                           cuda)
    rng = np.random.default_rng(n_lanes)
    planes = interop.planes_from_reference(
        rng.integers(0, 2 ** 32, (40, n_lanes),
                     dtype=np.uint64).astype(np.uint32), cuda)
    before = ap_ops.run_schedule.launches
    got, m = ap_ops.run_schedule(planes, *tabs)
    assert ap_ops.run_schedule.launches == before + 1
    want, m_want = ap_ops.run_schedule_plain(planes, *tabs)
    assert torch.equal(got, want) and torch.equal(m, m_want)


def test_ap_kernel_rejects_out_of_range_columns(cuda):
    planes = torch.zeros((4, 2), dtype=torch.int32, device=cuda)
    tab = torch.tensor([[7]], dtype=torch.int32, device=cuda)
    with pytest.raises(IndexError):
        ap_ops.run_schedule(planes, tab, tab * 0, tab * 0, tab * 0)

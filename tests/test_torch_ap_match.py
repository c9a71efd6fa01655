"""PyTorch port vs the JAX reference: the AP pass-schedule kernel.

Random bit planes (numpy seeds) run real schedules — the bit-serial adder
(``isa.add``), the m=6 multiply (``arith.mul_schedules``) and a lookup
table (``isa.lut``), bucketed and padded as ``APEngine.run`` pads them —
through the port's ``run_schedule`` (its plain version, on the CPU), the
reference's jnp oracle and its Pallas kernel in interpret mode.  Planes
and matched counts must be bit-identical.  The kernel-vs-plain check on
the card lives in ``test_torch_cuda_kernels.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import arith as jarith
from repro.core import isa as jisa
from repro.core.bitplane import Field as JField
from repro.core.engine import PassSchedule as JPassSchedule
from repro.core.engine import bucket_schedule as j_bucket
from repro.kernels.ap_match import ops as jops
from repro_torch import interop
from repro_torch.core import arith as tarith
from repro_torch.core import bitplane as tbp
from repro_torch.core import isa as tisa
from repro_torch.core.bitplane import Field as TField
from repro_torch.core.engine import PassSchedule as TPassSchedule
from repro_torch.core.engine import bucket_schedule as t_bucket
from repro_torch.kernels.ap_match import ops as tops

N_BITS = 40
LANES = [1, 4, 32, 33]


def _schedules(pkg_isa, pkg_arith, Field, PassSchedule):
    """name -> schedule of one package, on one shared column layout."""
    prod, carry = Field(20, 13), Field(33, 1)
    return {
        "add": pkg_isa.add(Field(0, 8), Field(8, 8), Field(16, 1)),
        "mul": PassSchedule.concat(pkg_arith.mul_schedules(
            Field(0, 6), Field(8, 6), prod, carry)),
        "lut": pkg_isa.lut(Field(0, 4), Field(34, 6),
                           lambda x: (x * x + 3) % 64),
    }


def _tables(name):
    js = _schedules(jisa, jarith, JField, JPassSchedule)[name]
    ts = _schedules(tisa, tarith, TField, TPassSchedule)[name]
    return js, ts


@pytest.mark.parametrize("name", ["add", "mul", "lut"])
def test_port_builds_the_reference_tables(name):
    js, ts = _tables(name)
    for f in ("cmp_cols", "cmp_key", "w_cols", "w_key", "kc", "kw"):
        np.testing.assert_array_equal(getattr(js, f), getattr(ts, f), f)
    for a, b in zip(j_bucket(js), t_bucket(ts)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_lanes", LANES)
@pytest.mark.parametrize("name", ["add", "mul", "lut"])
def test_run_schedule_bit_identical(name, n_lanes):
    js, _ = _tables(name)
    cc, ck, wc, wk = j_bucket(js)
    rng = np.random.default_rng(n_lanes * 7 + len(name))
    planes = rng.integers(0, 2 ** 32, (N_BITS, n_lanes),
                          dtype=np.uint64).astype(np.uint32)
    launches = tops.run_schedule.launches
    got, m = tops.run_schedule(
        interop.planes_from_reference(planes, "cpu"),
        *interop.schedule_from_reference(cc, ck, wc, wk, "cpu"))
    assert tops.run_schedule.launches == launches     # plain on the CPU
    got = interop.planes_to_reference(got)
    ref, m_ref = jops.run_schedule(jnp.asarray(planes), cc, ck, wc, wk,
                                   backend="jnp")
    pal, m_pal = jops.run_schedule(jnp.asarray(planes), cc, ck, wc, wk,
                                   backend="pallas", block_lanes=n_lanes)
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, np.asarray(pal))
    assert m.dtype == torch.int32
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_ref))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_pal))


def test_duplicate_write_columns_take_the_last_key():
    """Sequential read-modify-write per k: a column listed twice in one
    pass ends with its last key (the jnp oracle gathers then scatters,
    which agrees whenever duplicates carry one key, as padding does)."""
    planes = np.zeros((4, 2), np.uint32)
    cc = np.array([[0]], np.int32)
    ck = np.array([[0]], np.uint32)
    wc = np.array([[1, 2, 1]], np.int32)
    wk = np.array([[1, 1, 0]], np.uint32)
    got, m = tops.run_schedule_plain(
        interop.planes_from_reference(planes, "cpu"),
        *interop.schedule_from_reference(cc, ck, wc, wk, "cpu"))
    got = interop.planes_to_reference(got)
    assert int(m[0]) == 64
    np.testing.assert_array_equal(got[1], [0, 0])
    np.testing.assert_array_equal(got[2], [0xFFFFFFFF] * 2)


def test_popcount_swar_counts_all_32_bits():
    row = torch.tensor([-1, 0, 1, -2 ** 31, 0x55555555], dtype=torch.int32)
    assert int(tbp.popcount(row)) == 32 + 0 + 1 + 1 + 16

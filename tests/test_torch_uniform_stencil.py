"""PyTorch port vs the JAX reference: the uniform-per-layer stencil's pack
of per-layer vectors.

``thermal_stencil.ops.vectors`` returns the four per-layer vectors as one
checked ``[4, L]`` pack (``LayerVectors``), which the legacy solves build
once and hand to every launch; four loose tensors are packed, and
checked, on each call.  On the CPU the wrappers run the plain version,
which must equal the reference's jnp operator (``repro.core.thermal.
apply_operator``) bit for bit: both take the terms in the same order and
XLA contracts no multiply-add here.  The reference's Pallas kernel in
interpret mode sums in another order, so it is held to rtol 1e-5, as in
``test_torch_steady.py``.  The kernel-vs-plain check on the card is in
``test_torch_cuda_kernels.py``.
"""
import copy
import pickle

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import thermal as jthermal
from repro.kernels.thermal_stencil import ops as jops
from repro_torch.core import thermal as tthermal
from repro_torch.kernels.thermal_stencil import ops as tops

SHAPES = [(5, 16, 16), (3, 9, 13), (1, 8, 8), (7, 12, 10), (2, 3, 9, 13)]


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    L = shape[-3]
    T = (45.0 + 30.0 * rng.random(shape)).astype(np.float32)
    g_lat = rng.uniform(0.01, 0.2, L).astype(np.float32)
    g_vert = rng.uniform(0.1, 1.0, L - 1).astype(np.float32) if L > 1 \
        else np.float32(0.5)
    return T, g_lat, g_vert, 0.07


@pytest.mark.parametrize("shape", SHAPES)
def test_pack_and_loose_vectors_equal_reference_bit_for_bit(shape):
    T, g_lat, g_vert, g_pkg = _case(shape, sum(shape))
    L = shape[-3]
    pack = tops.vectors(L, g_lat, g_vert, g_pkg)
    assert type(pack) is tops.LayerVectors and pack.n_layers == L
    assert pack.data.shape == (4, L) and pack.data.is_contiguous()
    Tt = torch.from_numpy(T)
    before = tops.apply_operator.launches
    by_pack = tops.apply_operator_vectors(Tt, pack).numpy()
    loose = tops.apply_operator_vectors(Tt, *pack).numpy()
    ref_form = tops.apply_operator(Tt, g_lat, g_vert, g_pkg).numpy()
    assert tops.apply_operator.launches == before      # plain on the CPU
    for b, Tb in enumerate(T if T.ndim == 4 else [T]):
        want = np.asarray(jthermal.apply_operator(jnp.asarray(Tb), g_lat,
                                                  g_vert, g_pkg))
        for got in (by_pack, loose, ref_form):
            np.testing.assert_array_equal(got[b] if T.ndim == 4 else got,
                                          want)
        pallas = np.asarray(jops.apply_operator(jnp.asarray(Tb), g_lat,
                                                g_vert, g_pkg, block_y=4))
        np.testing.assert_allclose(
            by_pack[b] if T.ndim == 4 else by_pack, pallas, rtol=1e-5,
            atol=1e-5 * np.abs(pallas).max())


def test_pack_unpacks_as_four_vectors_and_survives_copies():
    pack = tops.vectors(4, np.float32([0.1, 0.2, 0.3, 0.4]),
                        np.float32([0.5, 0.6, 0.7]), 0.05)
    g_lat, gv_u, gv_d, g_pkg = pack
    f32 = lambda *x: np.float32(x)
    np.testing.assert_array_equal(gv_u.numpy(), f32(0, 0.5, 0.6, 0.7))
    np.testing.assert_array_equal(gv_d.numpy(), f32(0.5, 0.6, 0.7, 0))
    np.testing.assert_array_equal(g_pkg.numpy(), f32(0, 0, 0, 0.05))
    # the four vectors are views of the one tensor the kernel reads
    assert g_lat.data_ptr() == pack.data.data_ptr()
    for other in (copy.deepcopy(pack), pickle.loads(pickle.dumps(pack))):
        assert type(other) is tops.LayerVectors
        assert torch.equal(other.data, pack.data)
        assert other[3].data_ptr() == other.data[3].data_ptr()


@pytest.mark.parametrize("bad, match", [
    ("shape", "float32 \\[L\\]"), ("dtype", "float32 \\[L\\]"),
    ("device", "float32 \\[L\\]"), ("rank", "float32 \\[L\\]"),
    ("count", "four per-layer vectors")])
def test_pack_rejects_a_bad_vector_where_it_is_built(bad, match):
    v = [torch.zeros(3) for _ in range(4)]
    if bad == "shape":
        v[3] = torch.zeros(2)
    elif bad == "dtype":
        v[1] = torch.zeros(3, dtype=torch.float64)
    elif bad == "device":
        v[2] = torch.zeros(3, device="meta")
    elif bad == "rank":
        v[0] = torch.zeros(1, 3)
    else:
        v = v[:3]
    with pytest.raises((ValueError, TypeError), match=match):
        tops.pack_vectors(tuple(v))


def test_pack_is_built_once_and_returned_as_is():
    pack = tops.vectors(3, 0.1, 0.2, 0.3)
    assert tops.pack_vectors(pack) is pack
    again = tops.pack_vectors(tuple(pack))
    assert again is not pack and torch.equal(again.data, pack.data)


def test_kernel_dims_are_checked_once_a_shape():
    assert tops._uniform_dims(torch.Size((5, 384, 384)), 5) == \
        (1, 5, 384, 384)
    assert tops._uniform_dims(torch.Size((3, 5, 7, 9)), 5) == (3, 5, 7, 9)
    assert tops._uniform_dims(torch.Size((0, 5, 7, 9)), 5) == ()
    with pytest.raises(ValueError, match="L = 4"):
        tops._uniform_dims(torch.Size((5, 8, 8)), 4)
    with pytest.raises(NotImplementedError, match="32-bit"):
        tops._uniform_dims(torch.Size((4096, 8, 256, 256)), 8)
    with pytest.raises(NotImplementedError, match="65535 planes"):
        tops._uniform_dims(torch.Size((20000, 4, 2, 2)), 4)


def test_legacy_solves_build_the_pack_once():
    """``_cg_solve`` and the transients hand one pack to every launch: the
    pack their ``_vectors`` builds is what the stencil receives."""
    seen = []
    real = tops.apply_operator_vectors

    def spy(T, *vecs):
        seen.append(vecs)
        return real(T, *vecs)
    tops.apply_operator_vectors = spy
    try:
        shape = (3, 6, 6)
        b = torch.full(shape, 1e-3)
        diag = tthermal._diag(shape, 0.1, 0.2, 0.05)
        tthermal._cg_solve(b, diag, 0.1, 0.2, 0.05, max_iter=5)
        tthermal.transient(torch.full(shape, 45.0), torch.zeros(shape), 0.1,
                           0.2, 0.05, np.ones(3, np.float32), 1e-3, 3)
    finally:
        tops.apply_operator_vectors = real
    assert len(seen) > 3
    assert all(len(v) == 1 and type(v[0]) is tops.LayerVectors for v in seen)

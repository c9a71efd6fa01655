"""The port's flash attention (``repro_torch.kernels.flash_attention``) on
the CPU, where ``ops.mha`` runs its plain version, against the reference's
``ref.mha`` and its Pallas kernel in interpret mode, on the same inputs
made with NumPy from a seed.

Tolerance: rtol 1e-5, atol 2e-5 at float32, as the reference's own kernel
test (``tests/test_kernel_flash.py``); 2e-2 for bfloat16 inputs, whose
outputs are rounded to bfloat16 by both.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

import jax.numpy as jnp

from repro.kernels.flash_attention import ops as jops
from repro.kernels.flash_attention import ref as jref
from repro_torch.kernels.flash_attention import ops, ref

F32 = dict(rtol=1e-5, atol=2e-5)
BF16 = dict(rtol=2e-2, atol=2e-2)


def _mk(rng, B, sq, sk, hq, hkv, dh):
    return tuple(rng.normal(size=(B, s, h, dh)).astype(np.float32)
                 for s, h in ((sq, hq), (sk, hkv), (sk, hkv)))


def _port(arrs, dtype=torch.float32, **kw):
    out = ops.mha(*(torch.from_numpy(a).to(dtype) for a in arrs), **kw)
    assert out.dtype == dtype
    return out.float().numpy()


def _jax_ref(arrs, dtype=jnp.float32, **kw):
    return np.asarray(jref.mha(*(jnp.asarray(a, dtype) for a in arrs),
                               **kw).astype(jnp.float32))


def _jax_pallas(arrs, dtype=jnp.float32, block=32, **kw):
    return np.asarray(jops.mha(*(jnp.asarray(a, dtype) for a in arrs),
                               block_q=block, block_k=block,
                               **kw).astype(jnp.float32))


@pytest.mark.parametrize("B,sq,sk,hq,hkv,dh", [
    (2, 64, 64, 4, 4, 32),      # MHA square
    (2, 64, 64, 4, 2, 32),      # GQA
    (1, 128, 128, 8, 1, 64),    # MQA
    (2, 1, 96, 4, 4, 32),       # decode: 1 query vs KV cache
    (1, 50, 70, 2, 1, 16),      # ragged
])
@pytest.mark.parametrize("causal", [True, False])
def test_mha_matches_reference_fp32(B, sq, sk, hq, hkv, dh, causal):
    arrs = _mk(np.random.default_rng(B * sq + sk), B, sq, sk, hq, hkv, dh)
    got = _port(arrs, causal=causal)
    np.testing.assert_allclose(got, _jax_ref(arrs, causal=causal), **F32)
    np.testing.assert_allclose(got, _jax_pallas(arrs, causal=causal), **F32)


@pytest.mark.parametrize("window", [16, 48, 129])
def test_sliding_window_matches_reference(window):
    arrs = _mk(np.random.default_rng(window), 1, 128, 128, 4, 2, 32)
    got = _port(arrs, causal=True, window=window)
    np.testing.assert_allclose(
        got, _jax_ref(arrs, causal=True, window=window), **F32)
    np.testing.assert_allclose(
        got, _jax_pallas(arrs, causal=True, window=window), **F32)


def test_bf16_inputs_match_reference():
    arrs = _mk(np.random.default_rng(0), 2, 64, 64, 4, 4, 32)
    got = _port(arrs, torch.bfloat16, causal=True)
    np.testing.assert_allclose(
        got, _jax_ref(arrs, jnp.bfloat16, causal=True), **BF16)
    np.testing.assert_allclose(
        got, _jax_pallas(arrs, jnp.bfloat16, causal=True), **BF16)


@pytest.mark.parametrize("kv_len", [40, 70])
def test_kv_len_mask_matches_reference(kv_len):
    """Keys at or past ``kv_len`` are hidden (padded inputs)."""
    arrs = _mk(np.random.default_rng(kv_len), 1, 50, 70, 2, 1, 16)
    got = ref.mha(*(torch.from_numpy(a) for a in arrs), causal=True,
                  kv_len=kv_len).numpy()
    np.testing.assert_allclose(
        got, _jax_ref(arrs, causal=True, kv_len=kv_len), **F32)


def test_attention_mask_matches_reference():
    for kw in (dict(causal=True, window=None), dict(causal=False, window=5),
               dict(causal=True, window=3, kv_len=9)):
        np.testing.assert_array_equal(
            ref.attention_mask(7, 12, **kw).numpy(),
            np.asarray(jref.attention_mask(7, 12, **kw)))


def test_fully_masked_rows_are_zero():
    """A query row with no visible key gives 0, not NaN (window 0)."""
    arrs = _mk(np.random.default_rng(3), 1, 8, 8, 2, 2, 16)
    got = _port(arrs, causal=True, window=0)
    assert np.all(got == 0.0)
    np.testing.assert_array_equal(got, _jax_ref(arrs, causal=True, window=0))


@settings(max_examples=15, deadline=None)
@given(seed=st.integers(0, 1 << 16),
       sq=st.sampled_from([1, 17, 32, 64]),
       extra=st.integers(0, 64),
       hkv=st.sampled_from([1, 2, 4]),
       causal=st.booleans())
def test_property_mha(seed, sq, extra, hkv, causal):
    arrs = _mk(np.random.default_rng(seed), 1, sq, sq + extra, 4, hkv, 16)
    got = _port(arrs, causal=causal)
    np.testing.assert_allclose(got, _jax_ref(arrs, causal=causal), **F32)
    np.testing.assert_allclose(
        got, _jax_pallas(arrs, causal=causal, block=16), **F32)


def test_probability_mass_is_normalized():
    """Attention over constant V equals V (softmax sums to 1)."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(1, 32, 2, 16)).astype(np.float32)
    k = rng.normal(size=(1, 32, 2, 16)).astype(np.float32)
    v = np.full((1, 32, 2, 16), 3.5, np.float32)
    got = _port((q, k, v), causal=True)
    np.testing.assert_allclose(got, 3.5, rtol=1e-5)
    np.testing.assert_allclose(got, _jax_pallas((q, k, v), causal=True,
                                                block=16), **F32)


def test_wrapper_rejects_what_it_does_not_take():
    q = torch.zeros((1, 4, 3, 16))
    k = torch.zeros((1, 4, 2, 16))
    with pytest.raises(ValueError, match="multiple"):
        ops.mha(q, k, k)
    with pytest.raises(ValueError, match="backend"):
        ops.mha(q, q, q, backend="jnp")
    assert ops.mha.launches == 0       # the CPU runs the plain version

"""The flash backward kernel's tensor-core arithmetic, emulated in plain
PyTorch on the CPU and held to the kernel's tolerance.

The CUDA kernel (``kernels/flash_attention/csrc/flash_attention_bwd.cu``)
runs all five products on the tensor cores, in two kernels that each
recompute S and dP: one walks the query tiles that see a 64-key tile and
sums dK and dV, the other walks the key tiles that a 64-row query tile
sees and sums dQ.  float32 inputs go through 3xTF32 in every product
(hi = tf32(x), lo = x - hi read as TF32, a.b = a_lo.b_hi + a_hi.b_lo +
a_hi.b_hi), with P = exp2(s * scale log2(e) - lse log2(e)).  bfloat16
inputs multiply exactly, and P and dS go into the second products
(dV += P^T.dO, dK += dS^T.Q, dQ += dS.K) rounded once to bfloat16; the
gradients are stored as bfloat16.

The emulation below repeats those products over the kernel's tiles and
holds dq, dk and dv to autograd through the plain version within
``FLASH_BWD_TOL`` of the card tests, normwise.  The float32 products
follow the mma.sync chain: steps of 8 along the contraction, each added
to the accumulator rounded toward zero, as the tensor cores round (the 8
products of a step summed exactly here, which the tolerance covers);
each tile's sum starts at 0 and is added to the running one in float32.
Two controls show why: one TF32 rounding of each operand misses the
float32 limit, and so does one chain over whisper's 1500 keys, where
64-key tiles hold it.  Nothing on the port's path uses the helpers
here.
"""
import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import compare, ref
from test_torch_flash_split import split_tf32, tf32

#: normwise ||emulated - plain|| / ||plain|| of each gradient, as
#: tests/test_torch_cuda_kernels.py holds the kernel to the plain version
FLASH_BWD_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
BT = 64            # keys a dK/dV tile, query rows a dQ tile


def round_toward_zero(x: torch.Tensor) -> torch.Tensor:
    """float64 to float32, rounded toward zero."""
    x32 = x.to(torch.float32)
    over = x32.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(x32, torch.zeros_like(x32)),
                       x32)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as the kernel's mma.sync chain: along the contraction, steps
    of 8, each the three TF32 terms (lo.hi, hi.lo, hi.hi) added in turn
    to a float32 accumulator that starts at 0; the tensor core rounds
    each step's sum toward zero (the 8 exact products summed in float64
    here, which the tolerance covers)."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float64)
    for k0 in range(0, a.shape[-1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = round_toward_zero(
                acc + x[..., ks].double() @ y[..., ks, :].double()).double()
    return acc.float()


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with each operand rounded once to TF32 (the control)."""
    return tf32(a) @ tf32(b)


def mm_bf16(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b of bf16 values (the inputs, or P and dS rounded once):
    products exact, sums in float32."""
    return a.to(torch.bfloat16).float() @ b.to(torch.bfloat16).float()


ARITHMETIC = {"3xtf32": mm_3xtf32, "1xtf32": mm_1xtf32, "bf16": mm_bf16}


def _tile(d: int) -> int:
    """Rows of the looped-over tile: 64 for head dims up to 64, else 32."""
    return 64 if d <= 64 else 32


def forward_stats(q, k, v, *, causal, window):
    """The forward kernel's float32 output and row log-sum-exp (+inf for
    a row with no visible key), from the plain version."""
    hq, hkv, dh = q.shape[2], k.shape[2], q.shape[3]
    out = ref.mha(q.float(), k.float(), v.float(), causal=causal,
                  window=window)
    kf = k.float().repeat_interleave(hq // hkv, 2)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * dh ** -0.5
    mask = ref.attention_mask(q.shape[1], k.shape[1], causal=causal,
                              window=window)
    lse = torch.logsumexp(torch.where(mask, s, -math.inf), -1)
    return out, torch.where(mask.any(-1), lse, math.inf)


def emulated_backward(q, k, v, d_out, *, causal, window, arithmetic):
    """(dq, dk, dv) by the kernel's two tile loops with the products of
    ``ARITHMETIC[arithmetic]``; each in its input's dtype."""
    mm = ARITHMETIC[arithmetic]
    B, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    rep = hq // hkv
    scale = dh ** -0.5
    scale2 = torch.tensor(scale * math.log2(math.e), dtype=torch.float32)
    out, lse = forward_stats(q, k, v, causal=causal, window=window)
    nl = -lse * math.log2(math.e)                         # [B, Hq, Sq]
    delta = (d_out.float() * out).sum(-1).transpose(1, 2)  # [B, Hq, Sq]
    qf, dof = (t.float().transpose(1, 2) for t in (q, d_out))
    kf, vf = (t.float().transpose(1, 2).repeat_interleave(rep, 1)
              for t in (k, v))
    mask = ref.attention_mask(sq, sk, causal=causal, window=window)
    bf16 = arithmetic == "bf16"

    def p_ds(s, dp, rows, keys):
        """P and dS of a [.., rows, keys] tile of S and dP."""
        seen = mask[rows][:, keys]
        p = torch.exp2(s * scale2 + nl[..., rows, None])
        p = torch.where(seen, p, 0.0)
        return p, p * (dp - delta[..., rows, None])

    # dK, dV: a 64-key tile at a time over its query tiles; the GQA
    # group's heads summed at the end, in head order
    bi = _tile(dh)
    dk = torch.zeros((B, hq, sk, dh))
    dv = torch.zeros((B, hq, sk, dh))
    for k0 in range(0, sk, BT):
        keys = slice(k0, k0 + BT)
        for q0 in range(0, sq, bi):
            rows = slice(q0, q0 + bi)
            st = mm(kf[:, :, keys], qf[:, :, rows].transpose(-1, -2))
            dpt = mm(vf[:, :, keys], dof[:, :, rows].transpose(-1, -2))
            p, ds = p_ds(st.transpose(-1, -2), dpt.transpose(-1, -2), rows,
                         keys)
            dv[:, :, keys] += mm(p.transpose(-1, -2), dof[:, :, rows])
            dk[:, :, keys] += mm(ds.transpose(-1, -2), qf[:, :, rows])
    dk = dk.view(B, hkv, rep, sk, dh).sum(2) * scale
    dv = dv.view(B, hkv, rep, sk, dh).sum(2)

    # dQ: a 64-row query tile at a time over its key tiles
    bj = _tile(dh)
    dq = torch.zeros((B, hq, sq, dh))
    for q0 in range(0, sq, BT):
        rows = slice(q0, q0 + BT)
        for j0 in range(0, sk, bj):
            keys = slice(j0, j0 + bj)
            s = mm(qf[:, :, rows], kf[:, :, keys].transpose(-1, -2))
            dp = mm(dof[:, :, rows], vf[:, :, keys].transpose(-1, -2))
            _, ds = p_ds(s, dp, rows, keys)
            dq[:, :, rows] += mm(ds, kf[:, :, keys])
    dq = dq * scale
    dtype = torch.bfloat16 if bf16 else torch.float32
    return tuple(t.transpose(1, 2).to(dtype) for t in (dq, dk, dv))


#: (B, Sq, Sk, Hq, Hkv, dh, causal, window): causal MHA over ragged
#: tiles, GQA with a window inside a tile and dh = 120 (32-row looped
#: tiles), cross attention with Sq != Sk, and Sq > Sk under a causal mask
#: (the first 36 rows see no key)
CASES = {
    "causal_mha": (1, 130, 130, 2, 2, 64, True, None),
    "gqa_window": (1, 100, 100, 4, 2, 120, True, 20),
    "cross": (2, 40, 150, 2, 2, 32, False, None),
    "rows_without_keys": (1, 100, 64, 4, 2, 64, True, None),
}


def _inputs(case, dtype):
    B, sq, sk, hq, hkv, dh, _, _ = case
    rng = np.random.default_rng(sq + sk + dh)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dtype) for s in ((B, sq, hq, dh), (B, sk, hkv, dh),
                                      (B, sk, hkv, dh), (B, sq, hq, dh)))


def _gaps(case, dtype, arithmetic) -> dict:
    """The normwise gap of each emulated gradient to the plain one."""
    q, k, v, d_out = _inputs(case, dtype)
    kw = dict(causal=case[6], window=case[7])
    got = emulated_backward(q, k, v, d_out, arithmetic=arithmetic, **kw)
    want = ref.mha_backward(q.float(), k.float(), v.float(), d_out.float(),
                            **kw)
    gaps = {}
    for name, g, w, x in zip("qkv", got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape, name
        assert torch.isfinite(g).all(), name
        gaps[name] = float((g.double() - w.double()).norm()
                           / w.double().norm())
    return gaps


@pytest.mark.parametrize("case", list(CASES.values()), ids=list(CASES))
@pytest.mark.parametrize("dtype,arithmetic", [
    (torch.float32, "3xtf32"), (torch.bfloat16, "bf16")])
def test_backward_arithmetic_holds_flash_bwd_tol(case, dtype, arithmetic):
    gaps = _gaps(case, dtype, arithmetic)
    assert max(gaps.values()) <= FLASH_BWD_TOL[dtype], gaps


def test_one_tf32_rounding_misses_flash_bwd_tol():
    """The control: without the split the same inputs miss the float32
    limit, so the test above sees the split."""
    gaps = _gaps(CASES["causal_mha"], torch.float32, "1xtf32")
    assert max(gaps.values()) > FLASH_BWD_TOL[torch.float32], gaps


def test_tile_sums_keep_long_chains_within_tol():
    """dQ over whisper's 1500 cross-attention keys: one mma chain over
    every key, rounded toward zero at each step, drifts past the float32
    limit; the kernel's chain of one 64-key tile, added to the running
    sum in float32 (round to nearest), holds it.  dS is the exact one
    here, so the gap is the last product's alone."""
    rng = np.random.default_rng(7)
    ds, k = (torch.from_numpy(rng.normal(size=s)) for s in ((2, 64, 1500),
                                                              (2, 1500, 64)))
    ds = torch.softmax(ds, -1) * (ds - ds.mean(-1, keepdim=True))
    want = ds @ k
    ds, k = ds.float(), k.float()

    def gap(got):
        return float((got.double() - want).norm() / want.norm())
    chain = gap(mm_3xtf32(ds, k))
    tiles = gap(sum(mm_3xtf32(ds[..., j:j + BT], k[:, j:j + BT])
                    for j in range(0, 1500, BT)))
    tol = FLASH_BWD_TOL[torch.float32]
    assert chain > tol and tiles < tol / 4, (chain, tiles)


def test_rows_without_keys_get_zero_gradient():
    """dq of a row that sees no key is exactly 0 (P = 0 there, never
    NaN)."""
    case = CASES["rows_without_keys"]
    q, k, v, d_out = _inputs(case, torch.float32)
    dq, _, _ = emulated_backward(q, k, v, d_out, causal=True, window=None,
                                 arithmetic="3xtf32")
    assert torch.equal(dq[:, :36], torch.zeros_like(dq[:, :36]))
    assert dq[:, 36:].abs().max() > 0


def test_compare_holds_the_smoke_cases():
    """``compare`` times backward sources at ``chip_smoke.py``'s cases and
    holds them to its tolerance (the package cannot import the script, so
    it keeps copies)."""
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert compare.BWD_TIME_CASES == smoke.FLASH_BWD_CASES
    assert compare.BWD_TOL == smoke.FLASH_BWD_TOL
    assert {getattr(torch, k): v for k, v in compare.BWD_TOL.items()} \
        == FLASH_BWD_TOL

"""The flash kernel's tensor-core arithmetic, emulated in plain PyTorch on
the CPU and held to the kernel's tolerances.

The CUDA kernel (``kernels/flash_attention/csrc/flash_attention.cu``)
runs both products on the tensor cores.  float32 inputs go through
3xTF32: each operand is split as hi = tf32(x), where tf32 rounds the
mantissa to 10 bits, nearest with ties away from zero (what
``cvt.rna.tf32.f32`` gives), and lo = x - hi, exact in float32, which
the tensor core reads as TF32 by dropping its low 13 bits; then a.b =
a_lo.b_hi + a_hi.b_lo + a_hi.b_hi, each product exact in float32 and
summed in float32.  bfloat16 inputs
multiply exactly and feed P to the P.V product as two bfloat16 terms,
P_hi = bf16(p) and P_lo = bf16(p - P_hi).  Both run the online softmax
over 64-key tiles with exp2 and scale * log2(e) folded in.

The emulation below repeats that arithmetic (the sums in another order
than the tensor cores, which the tolerances cover) and holds it to the
plain version within ``FLASH_TOL`` of the card tests: 1e-4 absolute at
float32, one bfloat16 step (2^-7 relative) more for bfloat16.  The
float32 split is also held to a float64 attention within 1e-5.  Two
controls show why the kernel splits: one TF32 rounding of each operand,
or P rounded once to bfloat16, misses the same limits.  Nothing on the
port's path uses the helpers here.
"""
import math

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention import ref

#: (rtol, atol) in |emulated - plain| <= atol + rtol |plain|, as
#: tests/test_torch_cuda_kernels.py holds the kernel to its plain version
FLASH_TOL = {torch.float32: (0.0, 1e-4), torch.bfloat16: (2.0 ** -7, 1e-4)}
F64_TOL = 1e-5
BK = 64            # the kernel's key tile
NEG = -1e30


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10 mantissa bits, nearest, ties away
    from zero (``cvt.rna.tf32.f32``)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncated(x: torch.Tensor) -> torch.Tensor:
    """float32 with its low 13 mantissa bits dropped: how the tensor core
    reads a float32 register as a TF32 operand."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = tf32(x)
    return hi, tf32_truncated(x - hi)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b as three TF32 products, each exact in float32."""
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return al @ bh + ah @ bl + ah @ bh


def mm_1xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b with each operand rounded once to TF32 (the control)."""
    return tf32(a) @ tf32(b)


def pv_bf16_split(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    hi = p.to(torch.bfloat16).float()
    lo = (p - hi).to(torch.bfloat16).float()
    return hi @ v + lo @ v


def pv_bf16_once(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return p.to(torch.bfloat16).float() @ v


ARITHMETIC = {
    "3xtf32": (mm_3xtf32, mm_3xtf32),
    "1xtf32": (mm_1xtf32, mm_1xtf32),
    "bf16_split": (torch.matmul, pv_bf16_split),
    "bf16_once": (torch.matmul, pv_bf16_once),
}


def emulated_mha(q, k, v, *, causal, window, arithmetic):
    """The kernel's online softmax over 64-key tiles with the products of
    ``ARITHMETIC[arithmetic]``; q [B, Sq, Hq, dh], k/v [B, Sk, Hkv, dh],
    output in q's dtype."""
    qk, pv = ARITHMETIC[arithmetic]
    B, sq, hq, dh = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    qf = q.float().transpose(1, 2)
    kf = k.float().repeat_interleave(hq // hkv, 2).transpose(1, 2)
    vf = v.float().repeat_interleave(hq // hkv, 2).transpose(1, 2)
    mask = ref.attention_mask(sq, sk, causal=causal, window=window)
    scale2 = torch.tensor(dh ** -0.5 * math.log2(math.e),
                          dtype=torch.float32)
    m = torch.full((B, hq, sq, 1), NEG)
    l = torch.zeros((B, hq, sq, 1))
    o = torch.zeros((B, hq, sq, dh))
    for k0 in range(0, sk, BK):
        seen = mask[:, k0:k0 + BK]
        s = qk(qf, kf[:, :, k0:k0 + BK].transpose(-1, -2))
        s = torch.where(seen, s * scale2, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        p = torch.where(seen, torch.exp2(s - m_new), 0.0)
        alpha = torch.exp2(m - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        o = o * alpha + pv(p, vf[:, :, k0:k0 + BK])
        m = m_new
    out = o / torch.where(l == 0, 1.0, l)
    return out.transpose(1, 2).to(q.dtype)


def attention_f64(q, k, v, *, causal, window):
    hq, hkv = q.shape[2], k.shape[2]
    qd, kd, vd = (t.double() for t in (q, k, v))
    kd, vd = (t.repeat_interleave(hq // hkv, 2) for t in (kd, vd))
    s = torch.einsum("bqhd,bkhd->bhqk", qd, kd) * q.shape[-1] ** -0.5
    mask = ref.attention_mask(q.shape[1], k.shape[1], causal=causal,
                              window=window)
    p = torch.softmax(torch.where(mask, s, -math.inf), -1)
    p = torch.where(mask.any(-1)[:, None], p, 0.0).nan_to_num()
    return torch.einsum("bhqk,bkhd->bqhd", p, vd)


#: (B, Sq, Sk, Hq, Hkv, dh, causal, window): dh = 120 with GQA; Sk = 190
#: leaves a ragged last key tile, Sq = 150 a ragged 128-row query block,
#: and the window boundary falls inside key tiles
CASES = [
    (1, 150, 190, 4, 2, 120, True, 100),
    (2, 129, 129, 4, 1, 120, True, None),
    (1, 70, 190, 2, 2, 120, False, 70),
]


def _inputs(case, dtype):
    B, sq, sk, hq, hkv, dh, _, _ = case
    rng = np.random.default_rng(sq + sk + dh)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dtype) for s in ((B, sq, hq, dh), (B, sk, hkv, dh),
                                      (B, sk, hkv, dh)))


def _over_limit(got, want, dtype) -> float:
    """Largest |got - want| in units of the FLASH_TOL limit."""
    rtol, atol = FLASH_TOL[dtype]
    got, want = got.float(), want.float()
    return float(((got - want).abs() / (atol + rtol * want.abs())).max())


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype,arithmetic", [
    (torch.float32, "3xtf32"), (torch.bfloat16, "bf16_split")])
def test_split_arithmetic_holds_flash_tol(case, dtype, arithmetic):
    q, k, v = _inputs(case, dtype)
    kw = dict(causal=case[6], window=case[7])
    got = emulated_mha(q, k, v, arithmetic=arithmetic, **kw)
    assert got.dtype == dtype and got.shape == q.shape
    assert _over_limit(got, ref.mha(q, k, v, **kw), dtype) <= 1.0


@pytest.mark.parametrize("case", CASES)
def test_3xtf32_is_float32_accurate(case):
    q, k, v = _inputs(case, torch.float32)
    kw = dict(causal=case[6], window=case[7])
    got = emulated_mha(q, k, v, arithmetic="3xtf32", **kw)
    err = float((got.double() - attention_f64(q, k, v, **kw)).abs().max())
    assert err <= F64_TOL


@pytest.mark.parametrize("dtype,arithmetic", [
    (torch.float32, "1xtf32"), (torch.bfloat16, "bf16_once")])
def test_one_rounding_misses_flash_tol(dtype, arithmetic):
    """The controls: without the split, the same inputs miss the limit,
    so the tests above see the split."""
    case = CASES[0]
    q, k, v = _inputs(case, dtype)
    kw = dict(causal=case[6], window=case[7])
    got = emulated_mha(q, k, v, arithmetic=arithmetic, **kw)
    assert _over_limit(got, ref.mha(q, k, v, **kw), dtype) > 1.0


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0
    ulp = 2.0 ** -10                      # TF32's step at 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2),
                      one + ulp / 2 - 2.0 ** -23, one + 3 * ulp / 2, 3.0],
                     dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0])
    assert torch.equal(tf32(x), want)
    pi = torch.tensor([math.pi], dtype=torch.float32)
    hi, lo = split_tf32(pi)
    # hi + lo keeps 21 of float32's 24 significant bits
    assert hi != pi and float((hi + lo - pi).abs()) <= 2.0 ** -20 * math.pi
    assert torch.equal(tf32_truncated(x[:1]), torch.tensor([one]))


def test_fully_masked_rows_give_zero():
    q, k, v = _inputs((1, 8, 8, 2, 2, 120, True, 0), torch.float32)
    got = emulated_mha(q[:, :, :, :120], k, v, causal=True, window=0,
                       arithmetic="3xtf32")
    assert torch.equal(got, torch.zeros_like(got))

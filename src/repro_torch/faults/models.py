"""Deterministic fault models for the closed loop (PyTorch port of
``repro.faults.models``).

Real 3D thermal sensors are not the oracle the DTM controllers in
``repro_torch.policy`` assume: they are noisy, biased, quantized to the
DTS step, occasionally latch (stuck-at), and sometimes return garbage
(dropout).  A :class:`SensorFaultSpec` is a frozen, hashable description
of that sensing regime; it rides on
:class:`~repro_torch.stack.feedback.FeedbackParams`, and the replay calls
its :meth:`SensorFaultSpec.read` once an interval with the fault state
(PRNG key, interval counter, stuck-at latches) carried beside the policy
state.  Sub-faults whose knob is zero are skipped in Python, so a
disabled sub-fault costs nothing, and a replay without a spec runs none
of this.

**Seeded randomness is the reference's.**  Noise and dropout come from
``jax.random`` in the reference.  This module carries its own copy of
that counter-based generator — threefry2x32 with the key chain, ``split``
and the bits of ``uniform`` and ``normal`` exactly as JAX 0.9 computes
them with ``jax_threefry_partitionable`` on — in integer PyTorch ops, so
the same ``seed`` gives the same keys, bits and dropout masks as the
reference, on the CPU and on a card alike.  ``normal`` goes through
XLA's float32 ``erf_inv`` polynomial (:func:`erfinv`), repeated here;
``log1p``, ``sqrt`` and the rounding of its Horner steps may differ from
XLA's in the last bits, so a normal draw agrees with the reference's to
a few ulp, not bit for bit.

Port notes: readings of a case batch (``true_T`` ``[B, L]``) are
``[B, K, L]``; the reference vmaps :meth:`SensorFaultSpec.init_state`
over its batch, so every case reads the same key chain, and here every
case gets the same ``[K, L]`` draws.  The key and the interval counter
are shared by the batch; the stuck-at latch is per case.  The state is
made on the host and moves to the readings' device on the first read.

:class:`PowerFaultSpec` is the host-side counterpart for the *input*
trace: deterministic transient power spikes injected on selected
intervals of the dynamic-power frames before assembly (NumPy's generator,
as in the reference).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))

#: XLA's float32 erf_inv: Giles' polynomial in w = -log1p(-x^2), one set
#: of coefficients below w = 5 and one above (highest degree first)
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


# ---------------------------------------------------------------------------
# threefry2x32 and the jax.random key chain, in integer PyTorch ops
# ---------------------------------------------------------------------------

def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) of counter pairs ``(x1, x2)``
    under key ``(k1, k2)``: uint32 values held in int64 tensors (or
    Python ints for the key), broadcast together."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x[0] + x[1]) & _M32
            x1_ = (((x[1] << r) & _M32) | (x[1] >> (32 - r))) ^ x0
            x = [x0, x1_]
        x = [(x[0] + ks[(i + 1) % 3]) & _M32,
             (x[1] + ks[(i + 2) % 3] + i + 1) & _M32]
    return x[0], x[1]


def _f32(v: float) -> float:
    """``v`` rounded to float32 (a Python float): a weakly typed scalar
    as JAX casts it to a float32 operand."""
    return float(np.float32(v))


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` (32-bit seeds): int64 ``[2]`` holding
    the two uint32 words ``(seed >> 32, seed & 0xFFFFFFFF)``."""
    seed = int(seed)
    if not -2 ** 31 <= seed < 2 ** 31:
        raise OverflowError(f"seed {seed} is not a 32-bit integer")
    return torch.tensor([0, seed & _M32], dtype=torch.int64, device=device)


def _counters(shape, device) -> torch.Tensor:
    """The low words of ``iota_2x32_shape(shape)``: the flat index of
    every element (the high words are 0 below 2^32 elements)."""
    n = math.prod(shape)
    if n >= 2 ** 32:
        raise NotImplementedError("more than 2^32 random words")
    return torch.arange(n, dtype=torch.int64, device=device).reshape(shape)


def _hash(key: torch.Tensor, shape) -> tuple[torch.Tensor, torch.Tensor]:
    return threefry2x32(key[0], key[1], 0, _counters(shape, key.device))


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` (the fold-like split of
    ``jax_threefry_partitionable``): int64 ``[num, 2]``."""
    b1, b2 = _hash(key, (num,))
    return torch.stack([b1, b2], dim=1)


def random_bits(key: torch.Tensor, shape) -> torch.Tensor:
    """32 random bits per element (``jax.random.bits``), uint32 values in
    int64."""
    b1, b2 = _hash(key, tuple(shape))
    return b1 ^ b2


def _unit_floats(key: torch.Tensor, shape) -> torch.Tensor:
    """The float32 in ``[0, 1)`` JAX builds from 32 random bits: the top
    23 bits as the mantissa of a number in ``[1, 2)``, minus 1."""
    bits = (random_bits(key, shape) >> 9) | 0x3F800000
    return bits.to(torch.int32).view(torch.float32) - 1.0


def uniform(key: torch.Tensor, shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``
    (the bounds as float32 scalars, so nothing crosses to a card)."""
    lo = np.float32(minval)
    scale = float(np.float32(maxval) - lo)
    return torch.clamp(_unit_floats(key, shape) * scale + float(lo),
                       min=float(lo))


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 inverse error function (``lax.erf_inv``), repeated
    operation for operation; ±1 map to ±(largest float32)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    coef = lambda i: torch.where(lt, _f32(_ERFINV_LT5[i]),
                                 _f32(_ERFINV_GE5[i]))
    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return torch.where(x.abs() == 1, x * torch.finfo(x.dtype).max, p * x)


def normal(key: torch.Tensor, shape) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32: a uniform draw on
    ``(-1, 1)`` through ``sqrt(2) * erfinv`` (to a few ulp of JAX's)."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, lo, 1.0)
    return _f32(math.sqrt(2)) * erfinv(u)


# ---------------------------------------------------------------------------
# sensor faults
# ---------------------------------------------------------------------------

class FaultState(NamedTuple):
    """Fault carry of one replay.

    ``key``: the spec's PRNG chain (int64 ``[2]``); ``t``: interval
    counter (drives drift); ``latch`` ``[K, L]`` (or ``[B, K, L]`` once a
    batch has been read): stuck-at sensors' frozen readings (NaN = not
    yet latched); ``offset`` ``[K]``: per-sensor static bias drawn once at
    init from the seed.
    """
    key: torch.Tensor
    t: int
    latch: torch.Tensor
    offset: torch.Tensor


def _check_finite_nonneg(name: str, v: float) -> None:
    if not (math.isfinite(v) and v >= 0):
        raise ValueError(f"{name} must be finite and >= 0; got {v!r}")


@dataclasses.dataclass(frozen=True)
class SensorFaultSpec:
    """One deterministic sensing regime for the per-layer hot-spot DTS.

    The replay reads ``n_sensors`` redundant sensors per layer; naive
    policies see sensor 0 (``PolicyContext.layer_T``), hardened ones
    see all K (``PolicyContext.sensor_T``,
    :class:`~repro_torch.faults.guard.GuardedPolicy`).  Per reading, in
    order:

    - ``offset_C``: per-sensor static bias ~ N(0, offset_C), drawn once
      from the seed (sensor 0 included — calibration error).
    - ``drift_C``: common-mode linear drift, ``drift_C`` °C per interval.
    - ``noise_C``: white Gaussian read noise, sigma per reading.
    - ``quant_C``: DTS quantization step (round half to even).
    - ``n_stuck``: sensors ``[0, n_stuck)`` latch their FIRST reading
      forever (sensor 0 first, so one stuck sensor blinds exactly the
      naive policies).
    - ``p_dropout``: per reading per interval, probability the sample
      is lost and returned as NaN.
    """
    seed: int = 0
    n_sensors: int = 3
    noise_C: float = 0.0
    offset_C: float = 0.0
    drift_C: float = 0.0
    quant_C: float = 0.0
    n_stuck: int = 0
    p_dropout: float = 0.0

    def __post_init__(self):
        if self.n_sensors < 1:
            raise ValueError("n_sensors must be >= 1; got "
                             f"{self.n_sensors!r}")
        for name in ("noise_C", "offset_C", "quant_C"):
            _check_finite_nonneg(name, getattr(self, name))
        if not math.isfinite(self.drift_C):
            raise ValueError(f"drift_C must be finite; got {self.drift_C!r}")
        if not 0 <= self.n_stuck <= self.n_sensors:
            raise ValueError("n_stuck must lie in [0, n_sensors]; got "
                             f"{self.n_stuck!r}")
        if not (math.isfinite(self.p_dropout)
                and 0.0 <= self.p_dropout <= 1.0):
            raise ValueError("p_dropout must lie in [0, 1]; got "
                             f"{self.p_dropout!r}")

    @property
    def randomized(self) -> bool:
        """Does any enabled sub-fault consume PRNG randomness?"""
        return self.noise_C > 0 or self.p_dropout > 0

    def init_state(self, n_layers: int) -> FaultState:
        """The fault carry of a replay over ``n_layers`` layers, on the
        host (it moves to the readings' device on the first read)."""
        key = PRNGKey(self.seed)
        K = self.n_sensors
        if self.offset_C > 0:
            key, sub = split(key)
            offset = _f32(self.offset_C) * normal(sub, (K,))
        else:
            offset = torch.zeros(K, dtype=torch.float32)
        latch = torch.full((K, n_layers), math.nan, dtype=torch.float32)
        return FaultState(key=key, t=0, latch=latch, offset=offset)

    def read(self, state: FaultState, true_T: torch.Tensor
             ) -> tuple[FaultState, torch.Tensor]:
        """Sample all K sensors once: ``true_T`` ``[L]`` (or ``[B, L]``)
        -> readings ``[K, L]`` (or ``[B, K, L]``).  Nothing here reads a
        tensor back to the host.  Returns ``(state', readings)``."""
        dev = true_T.device
        key, latch, offset = state.key, state.latch, state.offset
        if key.device != dev:
            key, latch, offset = key.to(dev), latch.to(dev), offset.to(dev)
        K = self.n_sensors
        draw = (K,) + tuple(true_T.shape[-1:])          # one case's [K, L]
        r = true_T.to(torch.float32).unsqueeze(-2).expand(
            *true_T.shape[:-1], *draw)
        if self.offset_C > 0:
            r = r + offset[:, None]
        if self.drift_C != 0.0:
            r = r + float(np.float32(self.drift_C) * np.float32(state.t))
        if self.noise_C > 0:
            key, sub = split(key)
            r = r + _f32(self.noise_C) * normal(sub, draw)
        if self.quant_C > 0:
            r = torch.round(r / self.quant_C) * self.quant_C
        if self.n_stuck > 0:
            latch = torch.where(torch.isnan(latch), r, latch)
            stuck = (torch.arange(K, device=dev) < self.n_stuck)[:, None]
            r = torch.where(stuck, latch, r)
        if self.p_dropout > 0:
            key, sub = split(key)
            drop = uniform(sub, draw) < self.p_dropout
            r = torch.where(drop, math.nan, r)
        return FaultState(key=key, t=state.t + 1, latch=latch,
                          offset=offset), r


# ---------------------------------------------------------------------------
# input-trace faults: transient power spikes (host-side, pre-assembly)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PowerFaultSpec:
    """Deterministic transient power spikes on an interval trace.

    ``n_spikes`` intervals (chosen by the seeded generator, without
    replacement) have their dynamic-power frame scaled by ``magnitude``;
    each spike extends over ``width`` consecutive intervals.  Applied
    host-side by :func:`inject_power_spikes` BEFORE case assembly, so the
    replay itself is untouched.
    """
    seed: int = 0
    n_spikes: int = 1
    magnitude: float = 2.0
    width: int = 1

    def __post_init__(self):
        if self.n_spikes < 0:
            raise ValueError(f"n_spikes must be >= 0; got {self.n_spikes!r}")
        if self.width < 1:
            raise ValueError(f"width must be >= 1; got {self.width!r}")
        _check_finite_nonneg("magnitude", self.magnitude)


def inject_power_spikes(dyn_frames: np.ndarray,
                        spec: PowerFaultSpec) -> np.ndarray:
    """Scale ``spec.n_spikes`` seeded intervals of ``dyn_frames`` [T, ...]
    by ``spec.magnitude`` (each spike ``spec.width`` intervals long).
    Returns a new array; the input is not modified."""
    out = np.array(dyn_frames, copy=True)
    T = out.shape[0]
    if spec.n_spikes == 0 or T == 0:
        return out
    rng = np.random.default_rng(spec.seed)
    starts = rng.choice(T, size=min(spec.n_spikes, T), replace=False)
    for s in starts:
        out[s:s + spec.width] *= spec.magnitude
    return out


__all__ = ["SensorFaultSpec", "FaultState", "PowerFaultSpec",
           "inject_power_spikes", "PRNGKey", "split", "random_bits",
           "uniform", "normal", "erfinv", "threefry2x32"]

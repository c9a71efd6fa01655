"""Blocked (flash) attention forward: CUDA kernel and plain version.

:func:`mha` takes the model-layer layout q [B, Sq, Hq, dh], k/v
[B, Sk, Hkv, dh] (GQA allowed) and attends over the last Sq positions of
an Sk-long sequence.  For a tensor on the CPU it runs the plain
:func:`ref.mha`; for a CUDA tensor it launches the hand-written kernel
``csrc/flash_attention.cu`` (which replaces the TPU kernel
``flash_mha_kernel`` of the reference package) or raises — it never falls
back.  ``mha.launches`` counts kernel launches.

The kernel runs both products on the tensor cores (wgmma for bfloat16
inputs; 3xTF32 ``mma.sync`` for float32, which keeps float32 accuracy
whatever ``torch.backends.cuda.matmul.allow_tf32`` says), indexes the KV
head of query head h as ``h // (Hq // Hkv)`` instead of repeating K/V,
masks the ragged edges instead of padding, and skips key tiles that the
causal and window masks hide entirely (such a tile leaves the running
max, sum and output unchanged in the online softmax, so skipping it is
exact).

Gradients.  On a CUDA tensor that needs one, :func:`mha` runs through a
``torch.autograd.Function``: its forward is the same kernel, which also
writes each row's log-sum-exp, and its backward is
:func:`mha_backward`, the hand-written kernel
``csrc/flash_attention_bwd.cu`` (the reference has no backward kernel:
JAX differentiates its plain attention).  ``mha_backward.launches``
counts its launches (three kernels a launch: the row sums D, then dK/dV,
then dQ).  The backward too runs every product on the tensor cores
(3xTF32 ``mma.sync`` for float32, wgmma for bfloat16) and is
deterministic: a CTA owns a key tile for dK/dV and a query tile for dQ,
and sums it in a fixed order, with no atomics.  On the CPU, :func:`mha`
is the plain ``ref.mha`` and autograd differentiates it
(``ref.mha_backward`` is that plain backward, the kernel's oracle).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention import ref as _ref

#: head dims the kernel is compiled for (one template instance each)
HEAD_DIMS = (16, 32, 64, 120, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def mha(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
        causal: bool = True, window: int | None = None,
        scale: float | None = None, backend: str = "kernel",
        block_q: int = 64, block_k: int = 64) -> torch.Tensor:
    """Attention over the last Sq positions of an Sk-long sequence.

    ``backend="plain"`` forces the plain version on any device (the card
    tests compare the two with it; no path of the port passes it).
    ``block_q``/``block_k`` are the reference's tile knobs, accepted for
    its signature: the CUDA kernel's tile is fixed at 128 query rows by
    64 keys and its result does not depend on the tiling beyond float
    rounding.
    """
    if backend not in ("kernel", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "plain" or q.device.type == "cpu":
        return _ref.mha(q, k, v, causal=causal, window=window, scale=scale)
    scale = _check(q, k, v, window, scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    return _forward(q, k, v, causal, window, scale, want_lse=False)[0]


mha.launches = 0


def _check(q, k, v, window, scale) -> float:
    """Validate a card call's inputs; return the softmax scale."""
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be [B,Sq,Hq,dh] and k, v [B,Sk,Hkv,dh]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, sq, hq, dh = q.shape
    _, sk, hkv, dk = k.shape
    if k.shape[0] != B or dk != dh:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} differ "
                         "in batch or head dim")
    if hq % hkv:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={hkv}")
    if window is not None and window < 0:
        raise ValueError(f"window must be None or >= 0; got {window}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"head dim {dh}: the kernel takes {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {list(_DTYPES)}; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("q, k and v must lie on one device")
    return float(scale if scale is not None else dh ** -0.5)


def _forward(q, k, v, causal, window, scale, want_lse):
    """The forward kernel: (out in q's dtype, out f32, lse f32 [B, Hq, Sq]
    or None)."""
    B, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    q, k, v = (_aligned(t) for t in (q, k, v))
    out = torch.empty((B, sq, hq, dh), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, hq, sq), dtype=torch.float32, device=q.device) \
        if want_lse else None
    if out.numel() == 0 or sk == 0:
        if lse is not None:
            lse.fill_(float("inf"))
        return out.zero_().to(q.dtype), out, lse
    rc = _lib().flash_mha_lse(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        B, sq, sk, hq, hkv, dh, _DTYPES[q.dtype], int(causal),
        -1 if window is None else int(window), ctypes.c_float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_mha")
    mha.launches += 1
    return out.to(q.dtype), out, lse


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, saving q, k, v, its float32 output and the row
    log-sum-exp; the backward kernel for the gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        out, out_f32, lse = _forward(q, k, v, causal, window, scale,
                                     want_lse=True)
        ctx.save_for_backward(q, k, v, out_f32, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out_f32, lse = ctx.saved_tensors
        causal, window, scale = ctx.mask
        dq, dk, dv = mha_backward(q, k, v, out_f32, lse, d_out,
                                  causal=causal, window=window, scale=scale)
        return dq, dk, dv, None, None, None


def mha_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, lse: torch.Tensor, d_out: torch.Tensor,
                 *, causal: bool = True, window: int | None = None,
                 scale: float | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`mha` at (q, k, v), given its float32 output
    ``out`` and row log-sum-exp ``lse`` [B, Hq, Sq] from the forward
    kernel and the output's gradient ``d_out``; each gradient in its
    input's dtype.

    It launches ``csrc/flash_attention_bwd.cu`` or raises: only
    :class:`_FlashAttention` calls it, on CUDA tensors (on the CPU,
    autograd differentiates the plain ``ref.mha``).
    """
    scale = _check(q, k, v, window, scale)
    B, sq, hq, dh = q.shape
    _, sk, hkv, _ = k.shape
    q, k, v = (_aligned(t) for t in (q, k, v))
    d_out = _aligned(d_out.to(q.dtype))
    out, lse = _aligned(out.float()), _aligned(lse.float())
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if q.numel() == 0 or sk == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, hq, sq), dtype=torch.float32, device=q.device)
    rc = _bwd_lib().flash_mha_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        d_out.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, sq, sk, hq, hkv, dh,
        _DTYPES[q.dtype], int(causal), -1 if window is None else int(window),
        ctypes.c_float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(rc, "flash_mha_bwd")
    mha_backward.launches += 1
    return dq, dk, dv


mha_backward.launches = 0


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous, with a 16-byte aligned base (the kernel's vector
    loads need it; a view with a storage offset may not have one)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention")
    fn = lib.flash_mha_lse
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_void_p]
    return lib


def _bwd_lib() -> ctypes.CDLL:
    lib = _build.load("flash_attention_bwd")
    fn = lib.flash_mha_bwd
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 9 \
            + [ctypes.c_float, ctypes.c_void_p]
    return lib

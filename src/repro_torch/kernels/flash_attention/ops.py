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

Gradients.  :func:`mha` is one call of the operator
``torch.ops.repro_torch.flash_mha`` (``torch.library``); where a gradient
will be taken it runs in a ``torch.autograd.Function`` whose backward is
one call of the operator ``flash_mha_backward``.  On a CUDA tensor the
forward is the kernel, which also writes each row's log-sum-exp when a
gradient will be taken, and the backward is :func:`mha_backward`, the
hand-written kernel ``csrc/flash_attention_bwd.cu`` (the reference has
no backward kernel: JAX differentiates its plain attention).
``mha_backward.launches`` counts its launches (three kernels a launch:
the row sums D, then dK/dV, then dQ).  The backward too runs every
product on the tensor cores (3xTF32 ``mma.sync`` for float32, wgmma for
bfloat16) and is deterministic: a CTA owns a key tile for dK/dV and a
query tile for dQ, and sums it in a fixed order, with no atomics.  On
the CPU the forward is the plain ``ref.mha`` and the backward its
autograd gradient (``ref.mha_backward`` is that gradient, the kernel's
oracle).  On fake tensors both only allocate their outputs.

Counting.  A dispatch mode sees one ``flash_mha`` a call and one
``flash_mha_backward`` a gradient, never the kernels' or the plain
version's insides; with none active, a call on the card skips the
dispatcher and calls the same kernels straight.  Both carry a flop formula
(``torch.utils.flop_counter.register_flop_formula``) by PyTorch's SDPA
convention: :func:`attention_flops`, :func:`attention_backward_flops`.
"""
from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

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

    One call of the operator ``torch.ops.repro_torch.flash_mha`` (its
    gradient ``flash_mha_backward``) wherever a dispatch mode can see
    it: the kernels on the card, the plain version on the CPU, outputs
    alone on fake tensors (on the card with no mode active, the same
    kernels straight).  ``backend="plain"`` calls the plain version
    directly on any device (the card tests compare the two with it; no
    path of the port passes it).  ``block_q``/``block_k`` are the
    reference's tile knobs, accepted for its signature: the CUDA
    kernel's tile is fixed at 128 query rows by 64 keys and its result
    does not depend on the tiling beyond float rounding.
    """
    if backend not in ("kernel", "plain"):
        raise ValueError(f"unknown backend {backend!r}")
    if backend == "plain":
        return _ref.mha(q, k, v, causal=causal, window=window, scale=scale)
    if q.device.type == "cuda":
        scale = _check(q, k, v, window, scale)
    else:
        if q.shape[2] % k.shape[2]:
            raise ValueError(f"Hq={q.shape[2]} not a multiple of "
                             f"Hkv={k.shape[2]}")
        scale = float(scale if scale is not None else q.shape[-1] ** -0.5)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashAttention.apply(q, k, v, causal, window, scale)
    if _watched(q):
        return torch.ops.repro_torch.flash_mha(q, k, v, causal, window,
                                               scale, False)[0]
    return _forward(q, k, v, causal, window, scale, want_lse=False)[0]


mha.launches = 0


def _watched(q: torch.Tensor) -> bool:
    """Whether :func:`mha` goes through its operators: always but for a
    plain CUDA tensor with no dispatch mode active (a cost counter,
    ``FlopCounterMode``, fake tensors), where it calls the kernels
    straight, as the operators' CUDA bodies do, without the dispatcher's
    round trip (a decode-sized call is launch-bound: some 10-30 µs of
    host time a call on the card's host)."""
    return (q.device.type != "cuda" or type(q) is not torch.Tensor
            or torch._C._len_torch_dispatch_stack() > 0)


# ---------------------------------------------------------------------------
# the operators: one dispatcher call a forward and one a backward, so a
# TorchDispatchMode (the cost counter of ``launch/costing.py``,
# ``FlopCounterMode``) sees attention as one op on every device.  They are
# defined with ``torch.library.Library``, whose Python kernels cost less
# host time a call than ``torch.library.custom_op`` 's wrappers
# ---------------------------------------------------------------------------

_LIB = torch.library.Library("repro_torch", "DEF")
_LIB.define("flash_mha(Tensor q, Tensor k, Tensor v, bool causal, "
            "int? window, float scale, bool want_lse) "
            "-> (Tensor, Tensor, Tensor)")
_LIB.define("flash_mha_backward(Tensor q, Tensor k, Tensor v, Tensor out, "
            "Tensor lse, Tensor d_out, bool causal, int? window, "
            "float scale) -> (Tensor, Tensor, Tensor)")


def _flash_mha(q, k, v, causal, window, scale, want_lse):
    """(out in q's dtype, lse, o32).  With ``want_lse`` (a gradient will
    be taken), ``lse`` is each row's log-sum-exp [B, Hq, Sq] float32
    (+inf on a row with no visible key) and ``o32`` the float32 output
    the backward reads, empty where ``out`` is float32 already; without
    it both are empty."""
    def empty():
        # a fresh tensor each: an operator's outputs do not alias
        return torch.empty((0,), dtype=torch.float32, device=q.device)
    if q.device.type == "cuda":
        out, out_f32, lse = _forward(q, k, v, causal, window, scale,
                                     want_lse)
    elif want_lse:
        out_f32, lse = _ref.mha_lse(q, k, v, causal=causal, window=window,
                                    scale=scale)
        out = out_f32.to(q.dtype)
    else:
        out = _ref.mha(q, k, v, causal=causal, window=window, scale=scale)
    if not want_lse:
        return out, empty(), empty()
    return out, lse, (empty() if q.dtype == torch.float32 else out_f32)


def _flash_mha_backward(q, k, v, out, lse, d_out, causal, window, scale):
    """(dq, dk, dv): :func:`mha_backward` on the card; on the CPU the
    plain version's autograd gradient, ``ref.mha_backward``."""
    if q.device.type == "cuda":
        return mha_backward(q, k, v, out, lse, d_out, causal=causal,
                            window=window, scale=scale)
    # an operator's body runs below autograd; the plain gradient needs it
    # back (private API: the dispatcher's thread-local key sets)
    keys = torch._C.DispatchKey
    exclude = torch._C._dispatch_tls_local_exclude_set().remove(
        keys.AutogradFunctionality).remove(keys.ADInplaceOrView)
    with torch._C._ForceDispatchKeyGuard(
            torch._C._dispatch_tls_local_include_set(), exclude):
        grads = _ref.mha_backward(q, k, v, d_out.to(q.dtype), causal=causal,
                                  window=window, scale=scale)
    return tuple(g.detach() for g in grads)


for _key in ("CUDA", "CPU"):
    _LIB.impl("flash_mha", _flash_mha, _key)
    _LIB.impl("flash_mha_backward", _flash_mha_backward, _key)


@torch.library.register_fake("repro_torch::flash_mha", lib=_LIB)
def _(q, k, v, causal, window, scale, want_lse):
    B, sq, hq, _ = q.shape

    def empty():
        return q.new_empty((0,), dtype=torch.float32)
    if not want_lse:
        return torch.empty_like(q), empty(), empty()
    return (torch.empty_like(q),
            q.new_empty((B, hq, sq), dtype=torch.float32),
            empty() if q.dtype == torch.float32
            else torch.empty_like(q, dtype=torch.float32))


@torch.library.register_fake("repro_torch::flash_mha_backward", lib=_LIB)
def _(q, k, v, out, lse, d_out, causal, window, scale):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class _FlashAttention(torch.autograd.Function):
    """``flash_mha`` with the log-sum-exp, saving q, k, v, the float32
    output and the log-sum-exp; ``flash_mha_backward`` for the
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, scale):
        if _watched(q):
            out, lse, o32 = torch.ops.repro_torch.flash_mha(
                q, k, v, causal, window, scale, True)
            o32 = o32 if o32.numel() else out
        else:
            out, o32, lse = _forward(q, k, v, causal, window, scale, True)
        ctx.save_for_backward(q, k, v, o32, lse)
        ctx.mask = (causal, window, scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, out, lse = ctx.saved_tensors
        if _watched(q):
            dq, dk, dv = torch.ops.repro_torch.flash_mha_backward(
                q, k, v, out, lse, d_out, *ctx.mask)
        else:
            dq, dk, dv = mha_backward(q, k, v, out, lse, d_out,
                                      causal=ctx.mask[0],
                                      window=ctx.mask[1],
                                      scale=ctx.mask[2])
        return dq, dk, dv, None, None, None


def attention_flops(q_shape, k_shape, v_shape) -> int:
    """The forward's flops by PyTorch's SDPA convention
    (``torch.utils.flop_counter.sdpa_flop_count``), in this module's
    layout [B, S, H, dh]: every (query, key) pair of both products,
    2 flops a multiply-add, with no discount for the causal or window
    mask.  GQA counts the query heads."""
    B, sq, hq, dq = q_shape
    sk, dv = k_shape[1], v_shape[-1]
    return 2 * B * hq * sq * sk * (dq + dv)


def attention_backward_flops(q_shape, k_shape, v_shape) -> int:
    """The backward's by the same convention
    (``sdpa_backward_flop_count``): the scores once more, then dP, dV,
    dQ and dK, five products; the kernel's own second recomputation of
    S and dP is not counted."""
    B, sq, hq, dq = q_shape
    sk, dv = k_shape[1], v_shape[-1]
    return 2 * B * hq * sq * sk * (3 * dq + 2 * dv)


@register_flop_formula(torch.ops.repro_torch.flash_mha)
def _fwd_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return attention_flops(q_shape, k_shape, v_shape)


@register_flop_formula(torch.ops.repro_torch.flash_mha_backward)
def _bwd_flops(q_shape, k_shape, v_shape, *args, **kwargs) -> int:
    return attention_backward_flops(q_shape, k_shape, v_shape)


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


def mha_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 out: torch.Tensor, lse: torch.Tensor, d_out: torch.Tensor,
                 *, causal: bool = True, window: int | None = None,
                 scale: float | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`mha` at (q, k, v), given its float32 output
    ``out`` and row log-sum-exp ``lse`` [B, Hq, Sq] from the forward
    kernel and the output's gradient ``d_out``; each gradient in its
    input's dtype.

    It launches ``csrc/flash_attention_bwd.cu`` or raises: the operator
    ``flash_mha_backward`` calls it on CUDA tensors (on the CPU it
    differentiates the plain ``ref.mha``).
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

"""Model assembly: init and forward for all 10 architectures.

Families, as in the reference's ``models/model.py``:
  dense   — pre-norm GQA transformer (stablelm, phi3, codeqwen, danube,
            qwen2-vl with its stub vision prefix)
  moe     — DeepSeek-V2(-lite): MLA attention + shared/routed MoE FFN
  ssm     — falcon-mamba: pure Mamba-1 stack
  hybrid  — zamba2: Mamba-2 backbone + ONE shared attn+MLP block re-applied
            every ``attn_every`` layers (weight re-use)
  encdec  — whisper: bidirectional encoder over stub audio embeddings +
            causal decoder with cross attention

Each layer stack is a Python loop over per-layer parameter dicts
(``params["layers"]``, ``params["dense_layers"]`` and
``params["enc_layers"]`` are lists; ``params["shared_block"]`` is one
dict), with no TF32 in the float32 matrix products.  ``forward`` and
``encode`` follow the caller's grad mode: the serving entry points run
them under ``torch.no_grad()``, and ``loss_fn`` differentiates them, each
block wrapped in ``torch.utils.checkpoint`` as ``PerfConfig.remat`` asks
(the reference's ``jax.checkpoint``).  Full-sequence GQA attention (dense,
the hybrid's shared block, whisper's encoder, decoder and cross
attention) goes through the flash kernel, whose gradient is the backward
kernel; MLA's attention stays plain PyTorch (``models/mla.py``).

Under tensor parallelism (``Sharder.tp``: a mesh whose ``model`` axis
has several ranks) each block runs on the rank's heads, ``d_ff``
columns, experts or ``d_inner`` channels, and each rank holds its
vocabulary rows of ``embed`` and columns of ``lm_head``: the embedding
sums the ranks' lookups, ``forward`` returns the rank's vocabulary
columns of the logits, and ``loss_fn`` reduces the cross-entropy's max
and sums over ``model`` (``parallel/tensor_parallel.py``).
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.utils.checkpoint as torch_checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.models import attention as attn_mod
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.layers import (NOSHARD, Sharder, dense_init,
                                       embed_init, f32_matmul, gelu_mlp,
                                       gelu_mlp_init, init_device, layernorm,
                                       rmsnorm, rmsnorm_init, swiglu,
                                       swiglu_init)
from repro_torch.parallel import tensor_parallel as TP


@dataclasses.dataclass(frozen=True)
class PerfConfig:
    """The reference's per-cell knobs, in its order.  ``parallelism``
    picks how a train step on a ``DeviceMesh`` splits its batch
    (``launch.steps.make_sharder``: ``"fsdp"`` over the whole mesh, with
    compute replicated over ``model``; ``"2d"`` over the data axes, with
    the compute split over ``model``).
    ``scan_layers`` is accepted and changes nothing (the port loops over
    layers in Python either way)."""
    remat: str = "full"                # none | full | dots | dots_nb
    attn_chunk: Optional[int] = None   # kv-chunked attention block size
    #                                    (MLA's online softmax; the flash
    #                                    kernel streams K/V anyway)
    accum_steps: int = 1               # gradient accumulation microbatches
    scan_layers: bool = True
    parallelism: str = "2d"
    moe_groups: int = 1                # GShard dispatch groups
    kv_quant: bool = False             # int8 KV cache (KIVI-style)
    opt_moments: str = "f32"           # bf16 halves optimizer-state memory


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` policies: keep matrix products' outputs, recompute the
    rest."""
    aten = torch.ops.aten
    if op in (aten.mm.default, aten.bmm.default, aten.addmm.default):
        return torch_checkpoint.CheckpointPolicy.MUST_SAVE
    return torch_checkpoint.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, policy: str):
    """``fn`` with its activations recomputed in the backward pass, as the
    reference's ``_remat``: ``none`` keeps them all; ``full`` keeps only
    the block's inputs; ``dots`` and ``dots_nb`` also keep the matrix
    products' outputs (one policy here: a batched product is a product).
    Outside a grad-recording region it is ``fn`` itself.  The results do
    not depend on the policy."""
    if policy not in ("none", "full", "dots", "dots_nb"):
        raise ValueError(policy)
    if policy == "none":
        return fn

    @functools.wraps(fn)
    def run(*args, **kwargs):
        if not torch.is_grad_enabled():
            return fn(*args, **kwargs)
        extra = {}
        if policy != "full":
            extra["context_fn"] = functools.partial(
                torch_checkpoint.create_selective_checkpoint_contexts,
                _save_dots)
        return torch_checkpoint.checkpoint(fn, *args, use_reentrant=False,
                                           **kwargs, **extra)
    return run


def _norm(x, p, cfg: ArchConfig):
    if cfg.norm_type == "layernorm":
        return layernorm(x, p["w"], p["b"], cfg.norm_eps)
    return rmsnorm(x, p["w"], cfg.norm_eps)


def _norm_init(d, cfg: ArchConfig, dtype, device=None):
    if cfg.norm_type == "layernorm":
        return {"w": torch.ones((d,), dtype=dtype, device=device),
                "b": torch.zeros((d,), dtype=dtype, device=device)}
    return {"w": rmsnorm_init(d, dtype, device)}


def vocab_padded(cfg: ArchConfig) -> int:
    """Embedding/vocab dim padded to a multiple of 256, as the reference
    pads it (the padded logits are real rows)."""
    return -(-cfg.vocab // 256) * 256


def n_segments(cfg: ArchConfig) -> int:
    """The hybrid's shared-block applications: one every ``attn_every``
    layers (the ``n_layers % attn_every`` trailing layers run after the
    last)."""
    return max(cfg.n_layers // cfg.attn_every, 1)


# ===========================================================================
# init
# ===========================================================================

def init_params(cfg: ArchConfig, gen: torch.Generator,
                dtype=torch.float32, *, device=None) -> dict:
    """Random weights at the reference's init scales, on ``device``
    (by default ``gen.device``).

    The numbers differ from the reference's (``jax.random`` and
    ``torch.Generator`` differ); ``interop.lm_params_from_seed`` makes
    the same weights for both packages.  ``device="meta"`` builds the
    tree's shapes and dtypes with no memory and no draw
    (``launch.steps.params_sds``).
    """
    d = cfg.d_model
    vp = vocab_padded(cfg)
    dev = init_device(gen, device)
    p: dict = {
        "embed": embed_init(gen, vp, d, dtype, device=dev),
        "lm_head": dense_init(gen, d, vp, dtype, device=dev),
        "final_norm": _norm_init(d, cfg, dtype, dev),
    }

    def norms(*names):
        return {n: _norm_init(d, cfg, dtype, dev) for n in names}

    def attn_block(attn, d_ff):
        return {"attn": attn,
                "mlp": swiglu_init(gen, d, d_ff, dtype, dev),
                **norms("ln1", "ln2")}

    def attn():
        return attn_mod.attn_init(gen, cfg, dtype, device=dev)

    def mla():
        return mla_mod.mla_init(gen, cfg, dtype, device=dev)

    def ssm_layer():
        return {"ssm": ssm_mod.ssm_init(gen, cfg, dtype, device=dev),
                **norms("ln")}

    if cfg.family == "dense":
        p["layers"] = [attn_block(attn(), cfg.d_ff)
                       for _ in range(cfg.n_layers)]
    elif cfg.family == "moe":
        nd = cfg.moe.first_dense
        d_ff_dense = cfg.moe.d_ff_dense or 4 * d
        p["dense_layers"] = [attn_block(mla(), d_ff_dense)
                             for _ in range(nd)]
        p["layers"] = [{"attn": mla(),
                        "moe": moe_mod.moe_init(gen, cfg, dtype, device=dev),
                        **norms("ln1", "ln2")}
                       for _ in range(cfg.n_layers - nd)]
    elif cfg.family == "ssm":
        p["layers"] = [ssm_layer() for _ in range(cfg.n_layers)]
    elif cfg.family == "hybrid":
        p["layers"] = [ssm_layer() for _ in range(cfg.n_layers)]
        p["shared_block"] = attn_block(attn(), cfg.d_ff)
    elif cfg.family == "encdec":
        p["enc_layers"] = [{"attn": attn(),
                            "mlp": gelu_mlp_init(gen, d, cfg.d_ff, dtype,
                                                 dev),
                            **norms("ln1", "ln2")}
                           for _ in range(cfg.n_enc_layers)]
        p["layers"] = [{"self_attn": attn(),
                        "cross_attn": attn(),
                        "mlp": gelu_mlp_init(gen, d, cfg.d_ff, dtype, dev),
                        **norms("ln1", "ln2", "ln3")}
                       for _ in range(cfg.n_layers)]
        p["enc_norm"] = _norm_init(d, cfg, dtype, dev)
    else:
        raise ValueError(cfg.family)
    return p


# ===========================================================================
# blocks (forward and prefill)
# ===========================================================================

def embed_tokens(params: dict, batch: dict, cfg: ArchConfig,
                 shd: Sharder = NOSHARD) -> torch.Tensor:
    """Token embeddings, the first ``n_prefix_embeds`` positions replaced
    by the stub frontend's ``prefix_embeds`` where the batch has them
    (whole on every rank under tensor parallelism)."""
    x = TP.embed(params["embed"], batch["tokens"], shd.tp)
    if cfg.n_prefix_embeds and "prefix_embeds" in batch:
        pe = batch["prefix_embeds"].to(x.dtype)
        x = torch.cat([pe, x[:, cfg.n_prefix_embeds:]], dim=1)
    return x


def positions_for(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def _dense_block(lp, x, positions, cfg, shd, chunk):
    h = attn_mod.attn_train(lp["attn"], _norm(x, lp["ln1"], cfg), positions,
                            cfg, shd, chunk=chunk)
    x = x + h
    x = x + swiglu(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
    return x


def _mla_dense_block(lp, x, positions, cfg, shd, chunk):
    h = mla_mod.mla_train(lp["attn"], _norm(x, lp["ln1"], cfg), positions,
                          cfg, shd, chunk=chunk)
    x = x + h
    x = x + swiglu(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
    return x


def _moe_block(lp, x, positions, cfg, shd, chunk, groups=1):
    h = mla_mod.mla_train(lp["attn"], _norm(x, lp["ln1"], cfg), positions,
                          cfg, shd, chunk=chunk)
    x = x + h
    y, aux = moe_mod.moe_ffn(lp["moe"], _norm(x, lp["ln2"], cfg), cfg, shd,
                             groups=groups)
    return x + y, aux


def _ssm_block(lp, x, cfg, shd):
    return x + ssm_mod.ssm_train(lp["ssm"], _norm(x, lp["ln"], cfg), cfg, shd)


def _whisper_sinusoid(S: int, d: int, dtype, device=None) -> torch.Tensor:
    pos = torch.arange(S, dtype=torch.float32, device=device)[:, None]
    i = torch.arange(d // 2, dtype=torch.float32, device=device)[None]
    ang = pos * torch.exp(-i * math.log(10000.0) / (d // 2 - 1))
    return torch.cat([torch.sin(ang), torch.cos(ang)], -1).to(dtype)


@f32_matmul()
def encode(params, audio_embeds, cfg: ArchConfig, shd: Sharder = NOSHARD,
           perf: PerfConfig = PerfConfig()) -> torch.Tensor:
    """Whisper encoder over stub frame embeddings [B, F, d]: non-causal
    self-attention through the flash kernel."""
    B, F, d = audio_embeds.shape
    x = audio_embeds + _whisper_sinusoid(F, d, audio_embeds.dtype,
                                         audio_embeds.device)
    pos = positions_for(B, F, x.device)

    def blk(lp, x):
        h = attn_mod.attn_train(lp["attn"], _norm(x, lp["ln1"], cfg), pos,
                                cfg, shd, causal=False)
        x = x + h
        return x + gelu_mlp(lp["mlp"], _norm(x, lp["ln2"], cfg), shd)
    blk = _remat(blk, perf.remat)
    for lp in params["enc_layers"]:
        x = blk(lp, x)
    return _norm(x, params["enc_norm"], cfg)


def _cross_kv(p, enc_out, cfg: ArchConfig, shd: Sharder = NOSHARD,
              whole: bool = False):
    """The cross attention's keys and values [B, F, heads, dh] from the
    encoder output: every KV head, or under tensor parallelism those of
    ``TensorParallel.kv_cols`` (``whole`` as there)."""
    B, F, _ = enc_out.shape
    wk, wv = p["wk"], p["wv"]
    if shd.tp is not None:
        enc_out = TP.copy_to_model(enc_out, shd.tp)
        wk = shd.tp.kv_cols(wk, cfg, whole)
        wv = shd.tp.kv_cols(wv, cfg, whole)
    k = (enc_out @ wk).reshape(B, F, -1, cfg.head_dim)
    v = (enc_out @ wv).reshape(B, F, -1, cfg.head_dim)
    return k, v


def _cross_attn(p, xq, enc_out, positions, enc_pos, cfg, shd, kv=None):
    """Decoder queries against every encoder frame (no mask, no rotary):
    one non-causal flash call, on the rank's heads under tensor
    parallelism.  ``kv`` are ``_cross_kv``'s where the caller has
    them."""
    B, S, _ = xq.shape
    tp = shd.tp
    wq = p["wq"]
    if tp is not None:
        xq = TP.copy_to_model(xq, tp)
        wq = tp.q_cols(wq, cfg)
    q = (xq @ wq).reshape(B, S, -1, cfg.head_dim)
    k, v = kv if kv is not None else _cross_kv(p, enc_out, cfg, shd)
    if tp is not None:
        k, v = tp.attn_kv(k, cfg), tp.attn_kv(v, cfg)
    out = flash.mha(q, k, v, causal=False)
    return attn_mod._out_proj(p, out.reshape(B, S, -1), cfg, shd)


def _dec_block(lp, x, enc_out, positions, enc_pos, cfg, shd, chunk):
    h = attn_mod.attn_train(lp["self_attn"], _norm(x, lp["ln1"], cfg),
                            positions, cfg, shd, chunk=chunk)
    x = x + h
    # cross attention: queries from decoder, K/V from encoder output
    xq = _norm(x, lp["ln2"], cfg)
    x = x + _cross_attn(lp["cross_attn"], xq, enc_out, positions, enc_pos,
                        cfg, shd)
    return x + gelu_mlp(lp["mlp"], _norm(x, lp["ln3"], cfg), shd)


def _hybrid_forward(params, x, positions, cfg, shd, perf):
    """Zamba2: the shared attn block before every ``attn_every`` mamba
    layers, then the trailing layers if ``n_layers % attn_every``."""
    per = cfg.attn_every
    n_seg = n_segments(cfg)
    layers = params["layers"]
    shared = _remat(functools.partial(
        _dense_block, positions=positions, cfg=cfg, shd=shd,
        chunk=perf.attn_chunk), perf.remat)
    ssm = _remat(functools.partial(_ssm_block, cfg=cfg, shd=shd), perf.remat)
    for seg in range(n_seg):
        x = shared(params["shared_block"], x)
        for lp in layers[seg * per:(seg + 1) * per]:
            x = ssm(lp, x)
    for lp in layers[n_seg * per:]:
        x = ssm(lp, x)
    return x


# ===========================================================================
# forward: tokens -> logits, aux
# ===========================================================================

@f32_matmul()
def forward(params: dict, batch: dict, cfg: ArchConfig,
            shd: Sharder = NOSHARD, perf: PerfConfig = PerfConfig()
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """tokens [B, S] (and ``audio_embeds`` [B, F, d] for encdec) ->
    (logits [B, S, vocab_p] (the rank's vocab_p / m columns under tensor
    parallelism), aux: the MoE load-balance loss summed over the MoE
    layers, 0 for the other families)."""
    B, S = batch["tokens"].shape
    x = shd.btd(embed_tokens(params, batch, cfg, shd))
    positions = positions_for(B, S, x.device)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    chunk = perf.attn_chunk

    def remat(fn, **kw):
        return _remat(functools.partial(fn, cfg=cfg, shd=shd, **kw),
                      perf.remat)

    if cfg.family == "dense":
        blk = remat(_dense_block, positions=positions, chunk=chunk)
        for lp in params["layers"]:
            x = blk(lp, x)
    elif cfg.family == "moe":
        blk = remat(_mla_dense_block, positions=positions, chunk=chunk)
        for lp in params["dense_layers"]:
            x = blk(lp, x)
        blk = remat(_moe_block, positions=positions, chunk=chunk,
                    groups=perf.moe_groups)
        for lp in params["layers"]:
            x, a = blk(lp, x)
            aux = aux + a
    elif cfg.family == "ssm":
        blk = remat(_ssm_block)
        for lp in params["layers"]:
            x = blk(lp, x)
    elif cfg.family == "hybrid":
        x = _hybrid_forward(params, x, positions, cfg, shd, perf)
    elif cfg.family == "encdec":
        enc_out = encode(params, batch["audio_embeds"], cfg, shd, perf)
        enc_pos = positions_for(B, enc_out.shape[1], x.device)
        blk = remat(_dec_block, enc_out=enc_out, positions=positions,
                    enc_pos=enc_pos, chunk=chunk)
        for lp in params["layers"]:
            x = blk(lp, x)
    else:
        raise ValueError(cfg.family)

    x = _norm(x, params["final_norm"], cfg)
    logits = shd.btv(head(params, x, shd))
    return logits, aux


def head(params: dict, x: torch.Tensor, shd: Sharder = NOSHARD
         ) -> torch.Tensor:
    """``x @ lm_head``: under tensor parallelism the rank's vocabulary
    columns of the logits."""
    return TP.copy_to_model(x, shd.tp) @ params["lm_head"]


# ===========================================================================
# loss
# ===========================================================================

def loss_fn(params: dict, batch: dict, cfg: ArchConfig,
            shd: Sharder = NOSHARD, perf: PerfConfig = PerfConfig()
            ) -> tuple[torch.Tensor, dict]:
    """(loss, {"nll", "aux"}): the mean next-token negative log-likelihood
    of ``batch["labels"]`` from float32 logits (logsumexp minus the gold
    logit), plus the MoE aux loss, as the reference's ``loss_fn``; over
    the whole vocabulary from each rank's columns under tensor
    parallelism."""
    logits, aux = forward(params, batch, cfg, shd, perf)
    nll = TP.cross_entropy(logits, batch["labels"], shd.tp).mean()
    loss = nll + aux
    return loss, {"nll": nll, "aux": aux}

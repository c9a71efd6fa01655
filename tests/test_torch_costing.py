"""The port's ``launch/costing.py`` against the reference's.

Both sides cost the same cells: the reference compiles its steps and
blocks with XLA on ``jax.make_mesh((1, 1), ("data", "model"),
axis_types=(Auto, Auto))`` (its ``make_local_mesh`` makes Explicit axes
on this JAX), the port counts its steps and blocks on fake tensors on
the one-device mesh.  One config a family at ``.reduced()`` size, x
{train with ``remat="full"`` and 2 microbatches, prefill, decode}.

The flop comparison runs at float32.  At bfloat16 XLA's CPU backend
normalises every bfloat16 operation to float32 and back, and counts
each of those converts as a flop (a decode's cache is converted whole,
twice, a layer), which the port's program does not execute: ROADMAP
Queue 3 item 15 has the bfloat16 ratios.  The ssm and hybrid families'
mamba blocks count up to 11 % more than the reference's: the port scans
a chunk in log2(chunk) Hillis-Steele steps where JAX's
``associative_scan`` is work-efficient (Queue 3 item 14), so they get a
bound of 12 %; every other total and component is held to 10 %.
"""
import contextlib
import functools

import numpy as np
import pytest
import torch

from repro_torch.configs import SHAPES, get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.kernels.flash_attention import ops as flash
from repro_torch.launch import roofline as RF
from repro_torch.launch.cells import perf_for
from repro_torch.launch.costing import (ComponentCoster, CostCounter,
                                        fake_mode, step_cost)
from repro_torch.models.model import PerfConfig, vocab_padded

FAMILIES = ("stablelm-1.6b", "deepseek-v2-lite-16b", "falcon-mamba-7b",
            "zamba2-1.2b", "whisper-base")
KINDS = ("train", "prefill", "decode")
CASES = [(a, k) for a in FAMILIES for k in KINDS]
CELLS = {"train": (ShapeCell("t", 128, 4, "train"),
                   dict(remat="full", accum_steps=2)),
         "prefill": (ShapeCell("p", 128, 2, "prefill"), dict(remat="none")),
         "decode": (ShapeCell("d", 128, 2, "decode"), dict(remat="none"))}
#: flops, relative, against the reference's reconstructed count
TOL = {"dense": 0.10, "moe": 0.10, "encdec": 0.10, "ssm": 0.12,
       "hybrid": 0.12}
ONE_DEVICE = (torch.device("cpu"),)


def _reference_mesh():
    import jax
    from jax.sharding import AxisType
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


@functools.lru_cache(maxsize=None)
def _reference(arch: str, shape, perf_kw: tuple, f32: bool,
               reduced: bool = True) -> dict:
    """The reference's ``reconstruct`` of a cell (flops only)."""
    import jax.numpy as jnp
    from repro.configs import get_config as jget
    from repro.launch import roofline as JRF
    from repro.launch.costing import ComponentCoster as JCoster
    from repro.launch.steps import (make_decode_step, make_prefill_step,
                                    make_train_step)
    from repro.models.model import PerfConfig as JPerf
    cfg = jget(arch).reduced() if reduced else jget(arch)
    cell = shape
    perf = JPerf(**dict(perf_kw))
    dtype = jnp.float32 if f32 else jnp.bfloat16
    mesh = _reference_mesh()
    make = {"train": make_train_step, "prefill": make_prefill_step,
            "decode": make_decode_step}[cell.kind]
    jt, args = make(cfg, cell, mesh, perf=perf, dtype=dtype)
    compiled = jt.lower(*args).compile()
    cost = compiled.cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    coll = JRF.parse_collectives(compiled.as_text())
    rec = JCoster(cfg, cell, mesh, perf, dtype=dtype).reconstruct(
        {"flops": float(cost.get("flops", 0.0)),
         "bytes_accessed": float(cost.get("bytes accessed", 0.0))},
        float(coll["total_wire_bytes"]))
    return {"total": rec["total"]["flops"],
            "components": {k: (v["cost"]["flops"], v["traced"], v["true"])
                           for k, v in rec["per_component"].items()}}


@functools.lru_cache(maxsize=None)
def _port(arch: str, shape, perf_kw: tuple, f32: bool,
          reduced: bool = True):
    """(the port's ``reconstruct`` of a cell, its direct step count)."""
    cfg = get_config(arch).reduced() if reduced else get_config(arch)
    perf = PerfConfig(**dict(perf_kw))
    dtype = torch.float32 if f32 else torch.bfloat16
    coster = ComponentCoster(cfg, shape, ONE_DEVICE, perf, dtype=dtype)
    run = step_cost(cfg, shape, ONE_DEVICE, perf, dtype=dtype)
    rec = coster.reconstruct({"flops": run.cost["flops"],
                              "bytes_accessed": run.cost["bytes"]},
                             run.cost["wire"])
    return rec, run


def _case(arch, kind, f32=True):
    cell, kw = CELLS[kind]
    key = (arch, cell, tuple(sorted(kw.items())), f32)
    return _reference(*key), _port(*key)


@pytest.mark.parametrize("arch,kind", CASES)
def test_component_names_and_true_counts_are_the_reference_s(arch, kind):
    ref, (rec, _) = _case(arch, kind)
    got = rec["per_component"]
    assert sorted(got) == sorted(ref["components"])
    for name, c in got.items():
        assert c["true"] == ref["components"][name][2], name
        # every layer runs in Python: each is traced
        assert c["traced"] == c["true"], name


@pytest.mark.parametrize("arch,kind", CASES)
def test_flops_match_the_reference_s(arch, kind):
    ref, (rec, _) = _case(arch, kind)
    tol = TOL[get_config(arch).family]
    got = rec["total"]["flops"]
    assert abs(got / ref["total"] - 1) <= tol, (got, ref["total"])
    for name, c in rec["per_component"].items():
        want = ref["components"][name][0]
        assert abs(c["cost"]["flops"] / want - 1) <= tol, \
            (name, c["cost"]["flops"], want)


def _embed_head_bound(cfg, cell, perf) -> float:
    """The embedding (as a one-hot product) and head products a
    microbatch runs: train forward and backward, 10 T d V; prefill the
    embedding of every token and the head of the last; decode one token
    of each."""
    d, V = cfg.d_model, vocab_padded(cfg)
    if cell.kind == "train":
        T = cell.global_batch // perf.accum_steps * cell.seq_len
        return 10.0 * T * d * V
    B = cell.global_batch
    T = B * (cell.seq_len if cell.kind == "prefill" else 1)
    return 2.0 * T * d * V + 2.0 * B * d * V


@pytest.mark.parametrize("arch,kind", CASES)
def test_reconstruct_total_is_the_direct_count(arch, kind):
    """``total`` is the step's direct count, and what the blocks leave
    (``embed_head``) is at most the embedding and head products: the
    blocks are counted as the step runs them."""
    _, (rec, run) = _case(arch, kind)
    assert rec["total"] == {"flops": run.cost["flops"],
                            "bytes": run.cost["bytes"],
                            "wire": run.cost["wire"]}
    cell, kw = CELLS[kind]
    cfg, perf = get_config(arch).reduced(), PerfConfig(**kw)
    emb = rec["embed_head"]["flops"]
    assert 0 <= emb <= _embed_head_bound(cfg, cell, perf), emb
    body = sum(c["true"] * c["cost"]["flops"]
               for c in rec["per_component"].values())
    A = perf.accum_steps if kind == "train" else 1
    opt = rec["optimizer"]["flops"]
    assert (opt > 0) == (kind == "train")
    assert A * (emb + body) + opt == pytest.approx(run.cost["flops"],
                                                   rel=1e-12)


def _chunk_scan_once(cfg, cell, perf) -> float:
    """The attention flops the reference's ``HloCostAnalysis`` does not
    see in a prefill with ``attn_chunk``: its online softmax scans the
    key chunks, and a scan body counts once, one chunk of S / chunk
    (Queue 3 item 16)."""
    full = flash.attention_flops(
        (cell.global_batch, cell.seq_len, cfg.n_heads, cfg.head_dim),
        (cell.global_batch, cell.seq_len, cfg.n_kv_heads, cfg.head_dim),
        (cell.global_batch, cell.seq_len, cfg.n_kv_heads, cfg.head_dim))
    return cfg.n_layers * full * (1 - perf.attn_chunk / cell.seq_len)


@pytest.mark.parametrize("shape,f32,low,high", [
    ("train_4k", False, 0.9, 1.1),
    ("prefill_32k", False, 0.9, 1.1),
    ("decode_32k", True, 0.9, 1.1),
    # bfloat16: XLA's CPU converts of the 32k cache (Queue 3 item 15;
    # measured 0.313)
    ("decode_32k", False, 0.25, 1.0),
])
def test_full_width_stablelm_matches_the_reference_s(shape, f32, low,
                                                     high):
    arch = "stablelm-1.6b"
    cell, perf = SHAPES[shape], perf_for(arch, shape)
    from dataclasses import asdict
    key = (arch, cell, tuple(sorted(asdict(perf).items())), f32, False)
    ref = _reference(*key)
    rec, run = _port(*key)
    got = rec["total"]["flops"]
    if shape == "train_4k" and not f32:
        assert ref["total"] == pytest.approx(1.4565e16, rel=1e-4)
    if perf.attn_chunk:
        got -= _chunk_scan_once(get_config(arch), cell, perf)
    assert low <= got / ref["total"] <= high, (got, ref["total"])
    assert sorted(rec["per_component"]) == sorted(ref["components"])
    assert run.memory["peak_bytes_per_device"] > 0


@pytest.mark.parametrize("kind", KINDS)
def test_a_real_step_counts_as_its_fake_run(kind):
    """The counter on a step over real tensors gives the fake run's
    flops exactly: what ``chip_smoke.py`` phase 31 (b) holds on the
    card."""
    from repro_torch import interop
    from repro_torch.launch.steps import (make_decode_step,
                                          make_prefill_step, make_train_step)
    from repro_torch.optim import adamw_init
    cfg = get_config("stablelm-1.6b").reduced()
    cell, kw = CELLS[kind]
    perf = PerfConfig(**kw)
    make = {"train": make_train_step, "prefill": make_prefill_step,
            "decode": make_decode_step}[kind]
    fn, _ = make(cfg, cell, ONE_DEVICE, perf=perf, dtype=torch.float32,
                 device="cpu")
    params = interop.lm_params_from_seed(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    B, S = cell.global_batch, cell.seq_len
    if kind == "train":
        A = perf.accum_steps
        tok = rng.integers(0, cfg.vocab, (A, B // A, S), dtype=np.int32)
        args = (params, adamw_init(params),
                {"tokens": tok, "labels": np.roll(tok, -1, -1)})
    elif kind == "prefill":
        args = (params, {"tokens": rng.integers(0, cfg.vocab, (B, S),
                                                dtype=np.int32)})
    else:
        from repro_torch.models import serve as SV
        args = (params, rng.integers(0, cfg.vocab, (B, 1), dtype=np.int32),
                SV.init_caches(cfg, B, S, torch.float32), S - 1)
    with CostCounter() as c:
        fn(*args)
    fake = step_cost(cfg, cell, ONE_DEVICE, perf, dtype=torch.float32)
    assert c.flops == fake.cost["flops"] > 0
    assert c.matmul_flops == fake.cost["matmul_flops"] > 0


def test_flash_op_is_the_plain_route_bit_for_bit_and_counted_by_sdpa():
    from torch.utils.flop_counter import (FlopCounterMode, sdpa_flop_count,
                                          sdpa_backward_flop_count)
    from repro_torch.kernels.flash_attention import ref
    g = torch.Generator().manual_seed(3)
    shapes = ((2, 9, 4, 16), (2, 13, 2, 16))
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.randn(shapes[0], generator=g).to(dtype)
        k, v = (torch.randn(shapes[1], generator=g).to(dtype)
                for _ in range(2))
        d_out = torch.randn(shapes[0], generator=g).to(dtype)
        for mask in (dict(causal=True), dict(causal=False),
                     dict(causal=True, window=3)):
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            want = ref.mha(*leaves, **mask)
            want_g = torch.autograd.grad(want, leaves, d_out)
            leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
            got = flash.mha(*leaves, **mask)
            got_g = torch.autograd.grad(got, leaves, d_out)
            assert torch.equal(got, want)
            assert torch.equal(flash.mha(q, k, v, **mask), want)
            assert all(torch.equal(a, b) for a, b in zip(got_g, want_g))
    assert flash.mha.launches == 0

    def bhsd(s):
        return (s[0], s[2], s[1], s[3])
    fwd = sdpa_flop_count(bhsd(shapes[0]), bhsd(shapes[1]), bhsd(shapes[1]))
    bwd = sdpa_backward_flop_count(bhsd(shapes[0]), bhsd(shapes[0]),
                                   bhsd(shapes[1]), bhsd(shapes[1]))
    for fake in (False, True):
        with (fake_mode() if fake else contextlib.nullcontext()):
            leaves = [torch.randn(s).requires_grad_(True)
                      for s in (shapes[0], shapes[1], shapes[1])]
            with torch.enable_grad(), FlopCounterMode(display=False) as fc, \
                    CostCounter() as cc:
                out = flash.mha(*leaves)
                out.sum().backward()
        assert fc.get_total_flops() == fwd + bwd
        assert cc.matmul_flops == fwd + bwd
        assert leaves[0].grad.shape == shapes[0]


def test_mrope_builds_without_a_data_dependent_shape():
    """M-RoPE picks each half-dim's stream by Python-side slices: bit
    for bit the per-dim index it replaces, and it runs on fake
    tensors."""
    from repro_torch.models import rope
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 7, 3, 32, generator=g)
    pos3 = torch.randint(0, 50, (3, 2, 7), generator=g)
    sections = (4, 6, 6)
    stream = torch.repeat_interleave(torch.arange(3), torch.tensor(sections))
    ang = torch.movedim(pos3.float()[stream], 0, -1) * rope.rope_freqs(32, 1e4)
    assert torch.equal(rope.apply_mrope(x, pos3, sections),
                       rope._rotate(x, ang))
    with fake_mode():
        out = rope.apply_mrope(torch.empty(2, 7, 3, 32),
                               torch.empty(3, 2, 7, dtype=torch.int64),
                               sections)
    assert out.shape == (2, 7, 3, 32)


def test_ring_formulas_live_in_one_helper():
    R = 1024.0
    assert RF.ring_wire_bytes("all-gather", R, 4) == R * 3 / 4
    assert RF.ring_wire_bytes("all-reduce", R, 4) == 2 * R * 3 / 4
    assert RF.ring_wire_bytes("reduce-scatter", R, 4) == R * 3
    assert RF.ring_wire_bytes("all-to-all", R, 4) == R * 3 / 4
    assert RF.ring_wire_bytes("collective-permute", R, 4) == R
    assert RF.ring_wire_bytes("all-reduce", R, 1) == 0.0
    hlo = ("%a = f32[256]{0} all-gather(f32[64]{0} %x), "
           "replica_groups=[4,4]<=[16]\n"
           "%b = bf16[8,128]{1,0} all-reduce(bf16[8,128]{1,0} %y), "
           "replica_groups={{0,1}}\n")
    out = RF.parse_collectives(hlo)
    assert out["all-gather"] == RF.ring_wire_bytes("all-gather", 1024, 4)
    assert out["all-reduce"] == RF.ring_wire_bytes("all-reduce", 2048, 2)
    assert out["counts"]["all-gather"] == out["counts"]["all-reduce"] == 1

"""The port's AdamW, gradient compression, data pipeline, checkpoints and
straggler monitor: against the reference on the same seeded inputs, and
twins of ``tests/test_runtime.py``'s tests of the same pieces.

Tolerances: the learning rate within one float32 ulp (XLA's float32
``cos`` and ``pow`` against PyTorch's); parameters and moments after
AdamW steps within 1e-6 relative normwise (the global norm sums its
leaves in another order); ``ef_compress``'s int8 payload bit for bit and
its scale and residual within one ulp; the data bit for bit.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data import SyntheticLM as JSyntheticLM
from repro.data import make_batch as j_make_batch
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro.runtime.trainer import StragglerMonitor as JStragglerMonitor
from repro_torch import configs as tcfg
from repro_torch import interop, tree
from repro_torch.checkpoint import (CheckpointManager, latest_step, restore,
                                    save)
from repro_torch.data import SyntheticLM, make_batch
from repro_torch.optim import adamw
from repro_torch.optim.compress import (compress_tree, ef_compress,
                                        ef_decompress, init_residuals)
from repro_torch.runtime.trainer import StragglerMonitor


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


# ------------------------------------------------------------------ AdamW
def _ref_tree(rng):
    """A reference-layout tree: matrices, a final norm vector, and a layer
    stack of 3 whose norm vectors the reference stacks to rank 2."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {"embed": f(16, 8), "final_norm": {"w": f(8)},
            "layers": {"attn": {"wq": f(3, 8, 8)}, "ln": {"w": f(3, 8)}}}


@pytest.mark.parametrize("moments", ["f32", "bf16"])
def test_adamw_matches_reference(moments):
    """Four updates with warmup and a clip that binds, then the decayed
    and undecayed leaves: parameters, moments and the metrics."""
    rng = np.random.default_rng(0)
    p_np = _ref_tree(rng)
    bf16 = moments == "bf16"
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=6, clip_norm=2.0)
    jcfg_ = jadamw.AdamWConfig(
        **kw, moments_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tcfg_ = adamw.AdamWConfig(
        **kw, moments_dtype=torch.bfloat16 if bf16 else torch.float32)
    jp = jax.tree_util.tree_map(jnp.asarray, p_np)
    jo = jadamw.adamw_init(jp, jcfg_)
    tp = interop.lm_params_from_reference(p_np, "cpu")
    to = adamw.adamw_init(tp, tcfg_)
    for step in range(4):
        g_np = jax.tree_util.tree_map(
            lambda a: (rng.normal(size=a.shape) * (step + 1))
            .astype(np.float32), p_np)
        jp, jo, jm = jadamw.adamw_update(
            jp, jax.tree_util.tree_map(jnp.asarray, g_np), jo, jcfg_)
        tp, to, tm = adamw.adamw_update(
            tp, interop.lm_params_from_reference(g_np, "cpu"), to, tcfg_)
        assert _ulps(tm["lr"].item(), float(jm["lr"])) <= 1, step
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6), step
    assert int(to["step"]) == int(jo["step"]) == 4
    want_p = dict(tree.paths(interop.lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jp), "cpu")))
    want_o = interop.opt_state_from_reference(
        jax.tree_util.tree_map(np.asarray, jo), "cpu")
    for got, want in ((dict(tree.paths(tp)), want_p),
                      (dict(tree.paths(to["m"])),
                       dict(tree.paths(want_o["m"]))),
                      (dict(tree.paths(to["v"])),
                       dict(tree.paths(want_o["v"])))):
        assert sorted(got) == sorted(want)
        for key, g in got.items():
            assert g.dtype == want[key].dtype, key
            assert _rel(g.float().numpy(), want[key].float().numpy()) \
                <= 1e-6, key


def test_adamw_decays_where_the_reference_does():
    """With zero gradients only weight decay moves a weight: the matrices
    and the stacked per-layer norm vectors move, the final norm does not
    (the reference's "matrices only" rule sees its stacked layer axis)."""
    p_np = _ref_tree(np.random.default_rng(1))
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=0)
    tp = interop.lm_params_from_reference(p_np, "cpu")
    before = {k: v.clone() for k, v in tree.paths(tp)}
    zeros = tree.map_(torch.zeros_like, tp)
    adamw.adamw_update(tp, zeros, adamw.adamw_init(tp, cfg), cfg)
    moved = {k for k, v in tree.paths(tp) if not torch.equal(v, before[k])}
    assert moved == {"embed", "layers/0/attn/wq", "layers/1/attn/wq",
                     "layers/2/attn/wq", "layers/0/ln/w", "layers/1/ln/w",
                     "layers/2/ln/w"}


def test_schedule_matches_reference_within_one_ulp():
    jc = jadamw.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=50)
    tc = adamw.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=50)
    for step in range(0, 60):
        want = float(jadamw.schedule(jnp.float32(step), jc))
        got = adamw.schedule(torch.tensor(step, dtype=torch.float32),
                             tc).item()
        assert _ulps(got, want) <= 1, step


# ------------------------------------------------------------ compression
def test_ef_compress_matches_reference():
    rng = np.random.default_rng(2)
    g = rng.normal(size=(257,)).astype(np.float32)
    r = (rng.normal(size=(257,)) * 1e-2).astype(np.float32)
    jq, js, jr = jcompress.ef_compress(jnp.asarray(g), jnp.asarray(r))
    tq, ts, tr = ef_compress(torch.from_numpy(g), torch.from_numpy(r))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert _ulps(ts.item(), float(js)) <= 1
    ulps = np.abs(tr.numpy().view(np.int32).astype(np.int64)
                  - np.asarray(jr).view(np.int32).astype(np.int64))
    assert ulps.max() <= 1


def test_ef_compress_bounded_error():
    rng = np.random.default_rng(0)
    g = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, scale, _ = ef_compress(g, torch.zeros_like(g))
    assert q.dtype == torch.int8
    recon = ef_decompress(q, scale)
    assert float((recon - g).abs().max()) <= float(scale) * 0.5 + 1e-6


def test_ef_error_feedback_unbiased_over_time():
    rng = np.random.default_rng(1)
    true_sum = np.zeros(64, np.float32)
    got_sum = np.zeros(64, np.float32)
    r = torch.zeros(64)
    for _ in range(50):
        g = torch.from_numpy(rng.normal(size=(64,)).astype(np.float32))
        q, s, r = ef_compress(g, r)
        true_sum += g.numpy()
        got_sum += ef_decompress(q, s).numpy()
    np.testing.assert_allclose(got_sum + r.numpy(), true_sum, rtol=1e-4,
                               atol=1e-4)


def test_compress_tree_shapes():
    params = {"w": torch.ones((4, 4)), "layers": [{"b": torch.ones((4,))}]}
    q, s, r = compress_tree(params, init_residuals(params))
    assert q["w"].dtype == torch.int8 and q["layers"][0]["b"].shape == (4,)
    assert s["w"].shape == () and r["w"].dtype == torch.float32


# ------------------------------------------------------------------- data
def test_data_matches_reference_bit_for_bit():
    for kw in (dict(vocab=1000, seq_len=64, global_batch=8, seed=3),
               dict(vocab=500, seq_len=32, global_batch=8, seed=1,
                    host_index=1, host_count=2)):
        a, b = JSyntheticLM(**kw), SyntheticLM(**kw)
        for step in (0, 5):
            for k, v in a.batch(step).items():
                np.testing.assert_array_equal(b.batch(step)[k], v)
            for k, v in a.microbatched(step, 2).items():
                np.testing.assert_array_equal(b.microbatched(step, 2)[k], v)


@pytest.mark.parametrize("name", ["whisper-base", "qwen2-vl-72b",
                                  "stablelm-1.6b"])
def test_make_batch_matches_reference(name):
    from repro import configs as jcfg
    jc = jcfg.get_config(name).reduced()
    tc = tcfg.get_config(name).reduced()
    for accum in (0, 2):
        want = j_make_batch(jc, 4, 16, seed=5, accum=accum)
        got = make_batch(tc, 4, 16, seed=5, accum=accum)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k])


def test_data_deterministic_and_step_addressable():
    p = SyntheticLM(vocab=1000, seq_len=64, global_batch=8, seed=3)
    np.testing.assert_array_equal(p.batch(5)["tokens"], p.batch(5)["tokens"])
    assert not np.array_equal(p.batch(5)["tokens"], p.batch(6)["tokens"])
    b = p.batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_data_host_sharding_consistent():
    whole = SyntheticLM(vocab=500, seq_len=32, global_batch=8, seed=1)
    h0 = SyntheticLM(vocab=500, seq_len=32, global_batch=8, seed=1,
                     host_index=0, host_count=2)
    h1 = SyntheticLM(vocab=500, seq_len=32, global_batch=8, seed=1,
                     host_index=1, host_count=2)
    w = whole.batch(7)["tokens"]
    np.testing.assert_array_equal(w[:4], h0.batch(7)["tokens"])
    np.testing.assert_array_equal(w[4:], h1.batch(7)["tokens"])


def test_data_has_learnable_structure():
    t = SyntheticLM(vocab=1000, seq_len=256, global_batch=4,
                    seed=0).batch(0)["tokens"]
    assert (t[:, 1:] == t[:, :-1]).mean() > 0.02


# ------------------------------------------------------------- checkpoints
def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": {"w": torch.from_numpy(rng.normal(size=(4, 8))
                                        .astype(np.float32)),
                  "b": torch.from_numpy(rng.normal(size=(8,))
                                        .astype(np.float32))},
            "layers": [{"m": torch.ones(3, dtype=torch.bfloat16) / 3},
                       {"m": torch.full((3,), 7.0, dtype=torch.bfloat16)}],
            "step": torch.tensor(7, dtype=torch.int32)}


def _meta(t):
    return tree.map_(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                           device="meta"), t)


def test_checkpoint_roundtrip(tmp_path):
    t = _tree()
    save(tmp_path, 12, t)
    assert latest_step(tmp_path) == 12
    out = restore(tmp_path, 12, t)
    for a, b in zip(tree.leaves(t), tree.leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # a target on "meta" gives the shapes and dtypes alone
    out = restore(tmp_path, 12, _meta(t), device="cpu")
    for a, b in zip(tree.leaves(t), tree.leaves(out)):
        assert b.device.type == "cpu" and torch.equal(a, b)


def test_checkpoint_atomicity_ignores_tmp(tmp_path):
    save(tmp_path, 3, _tree())
    (tmp_path / "step_00000009.tmp").mkdir()
    assert latest_step(tmp_path) == 3


def test_checkpoint_keep_last(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2, async_save=False)
    for s in (1, 2, 3, 4):
        mgr.save(s, _tree())
    steps = sorted(int(d.name[5:]) for d in tmp_path.iterdir()
                   if d.name.startswith("step_"))
    assert steps == [3, 4]


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save(tmp_path, 1, _tree())
    bad = _tree()
    bad["a"]["w"] = torch.zeros((5, 8))
    with pytest.raises(ValueError):
        restore(tmp_path, 1, bad)


def test_async_save_copies_before_the_tensors_change(tmp_path):
    """The step updates its tensors in place: what an async save writes
    is the tree as it was when ``save`` returned."""
    t = _tree()
    want = {k: v.clone() for k, v in tree.paths(t)}
    mgr = CheckpointManager(tmp_path, keep=3, async_save=True)
    mgr.save(5, t)
    for leaf in tree.leaves(t):
        leaf.add_(1)
    assert mgr.latest_step() == 5
    out = mgr.restore(5, t)
    for k, v in tree.paths(out):
        assert torch.equal(v, want[k]), k


def test_restore_onto_a_mesh_is_not_ported(tmp_path):
    """The re-mesh restore takes a ``DeviceMesh`` (tested in spawned
    worlds, ``test_torch_distributed_serve.py``) or the one-device mesh;
    anything else is refused with a ``TypeError`` that says so."""
    save(tmp_path, 1, _tree())
    with pytest.raises(TypeError, match="DeviceMesh"):
        restore(tmp_path, 1, _tree(), mesh=object(), specs={})
    out = restore(tmp_path, 1, _tree(), mesh=(torch.device("cpu"),),
                  specs={})
    for k, v in tree.paths(out):
        assert torch.equal(v, dict(tree.paths(_tree()))[k]), k


# --------------------------------------------------------------- straggler
def test_straggler_monitor_matches_reference():
    a, b = JStragglerMonitor(factor=3.0, alpha=0.5), \
        StragglerMonitor(factor=3.0, alpha=0.5)
    for dt in [0.1] * 8 + [1.0, 0.1, 0.5, 0.05, 2.0]:
        assert a.observe(dt) == b.observe(dt)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert b.stragglers == 2

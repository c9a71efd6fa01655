"""The port's train step and trainer against the reference's, on the CPU.

The config is ``tests/test_runtime.py``'s: stablelm-1.6b cut to 2 layers,
d 64, 2 heads of 32, vocab 512; 4 sequences of 32 tokens from
``SyntheticLM(seed=0)``; ``AdamWConfig(lr=1e-3, warmup_steps=2,
total_steps=10)``; float32.  The weights come from
``interop.lm_params_seed_numpy`` to both packages.

The reference's step is built on a mesh of Auto axes,
``jax.make_mesh((1, 1), ("data", "model"), axis_types=(Auto, Auto))``:
its own ``make_local_mesh`` calls ``jax.make_mesh`` with no axis types,
which makes Explicit axes on this JAX, and ``with_sharding_constraint``
inside ``loss_fn`` then fails (the cause of the reference's failing
``test_restart_resumes_identical_trajectory``).  The step function itself
is the reference's, unchanged.

Tolerances: both sides compute in float32 and sum in other orders (XLA's
CPU against PyTorch's; the global norm over leaves in sorted-key order
against the port's insertion order).  Per step the loss and grad_norm are
held to 1e-5 relative and the learning rate to one float32 ulp.  After
three AdamW steps the parameters and moments are held normwise, leaf by
leaf, to 1e-4 relative: Adam's first steps move a weight by about lr
times the sign of its gradient, so a weight whose gradient is within
float32 noise of zero may move another way.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import AxisType

from repro.configs import get_config as jget_config
from repro.configs.base import ShapeCell as JShapeCell
from repro.data import SyntheticLM as JSyntheticLM
from repro.launch.steps import make_train_step as j_make_train_step
from repro.models.model import PerfConfig as JPerfConfig
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as j_adamw_init
from repro.runtime.trainer import TrainerConfig as JTrainerConfig
from repro.runtime.trainer import train_loop as j_train_loop
from repro_torch import interop
from repro_torch import tree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.data import SyntheticLM
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import PerfConfig
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import TrainerConfig, train_loop

SHAPE = dict(n_layers=2, d_model=64, n_heads=2, n_kv_heads=2, d_ff=128,
             vocab=512, d_head=32)
B, S, SEED = 4, 32, 0
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
STEP_RTOL = 1e-5
STATE_RTOL = 1e-4


def _cfgs():
    return (dataclasses.replace(jget_config("stablelm-1.6b").reduced(),
                                **SHAPE),
            dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                                **SHAPE))


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))


def _ref_setup(remat, accum, total_steps=10):
    jc, tc = _cfgs()
    ts, _ = j_make_train_step(
        jc, JShapeCell("t", S, B, "train"), _auto_mesh(),
        perf=JPerfConfig(remat=remat, accum_steps=accum),
        opt_cfg=JAdamWConfig(**dict(OPT, total_steps=total_steps)),
        dtype=jnp.float32)
    pnp = interop.lm_params_seed_numpy(tc, SEED)
    params = jax.tree_util.tree_map(jnp.asarray, pnp)
    return ts, params, j_adamw_init(params)


def _port_setup(remat, accum, total_steps=10):
    _, tc = _cfgs()
    ts, sds = make_train_step(
        tc, ShapeCell("t", S, B, "train"), make_local_mesh(1, 1,
                                                           device="cpu"),
        perf=PerfConfig(remat=remat, accum_steps=accum),
        opt_cfg=AdamWConfig(**dict(OPT, total_steps=total_steps)),
        dtype=torch.float32, device="cpu")
    params = interop.lm_params_from_seed(tc, SEED, "cpu")
    return ts, params, adamw_init(params), sds


def _batch(pipe, step, accum):
    return pipe.microbatched(step, accum) if accum > 1 \
        else {k: v[None] for k, v in pipe.batch(step).items()}


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _ulps(a, b) -> int:
    return abs(int(np.float32(a).view(np.int32))
               - int(np.float32(b).view(np.int32)))


def _same_tree(port: dict, ref: dict, what: str):
    """Every leaf of the port's tree against the reference's (carried over
    with ``lm_params_from_reference``), normwise."""
    want = dict(tree.paths(interop.lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, ref), "cpu")))
    got = dict(tree.paths(port))
    assert sorted(got) == sorted(want), what
    for key, g in got.items():
        gap = _rel(g.float().numpy(), want[key].float().numpy())
        assert gap <= STATE_RTOL, (what, key, gap)


@pytest.mark.parametrize("remat,accum", [("none", 1), ("full", 1),
                                         ("none", 2), ("full", 2)])
def test_train_step_matches_reference(remat, accum):
    """Three steps: loss, grad_norm and lr per step, then the parameters
    and both moments."""
    jts, jp, jo = _ref_setup(remat, accum)
    ts, tp, to, (psds, osds, bsds) = _port_setup(remat, accum)
    assert tuple(bsds["tokens"].shape) == (accum, B // accum, S)
    assert bsds["tokens"].device.type == "meta"
    assert dict((k, tuple(v.shape)) for k, v in tree.paths(psds)) == \
        dict((k, tuple(v.shape)) for k, v in tree.paths(tp))
    pipe = SyntheticLM(512, S, B, seed=0)
    for step in range(3):
        b = _batch(pipe, step, accum)
        jp, jo, jm = jts(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tm = ts(tp, to, b)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=STEP_RTOL), step
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=STEP_RTOL), step
        assert _ulps(tm["lr"].item(), float(jm["lr"])) <= 1, step
    assert int(to["step"]) == int(jo["step"]) == 3
    _same_tree(tp, jp, "params")
    _same_tree(to["m"], jo["m"], "m")
    _same_tree(to["v"], jo["v"], "v")


def test_remat_and_accumulation_do_not_change_the_step():
    """The remat policy changes nothing (bit for bit); accumulating two
    microbatches of 2 gives the one batch of 4's loss and gradient norm
    within float32 rounding."""
    out = {}
    for remat, accum in (("none", 1), ("full", 1), ("dots", 1),
                         ("none", 2)):
        ts, p, o, _ = _port_setup(remat, accum)
        b = _batch(SyntheticLM(512, S, B, seed=0), 0, accum)
        p, o, m = ts(p, o, b)
        out[remat, accum] = (m, p)
    base_m, base_p = out["none", 1]
    for key in (("full", 1), ("dots", 1)):
        m, p = out[key]
        assert float(m["loss"]) == float(base_m["loss"]), key
        assert float(m["grad_norm"]) == float(base_m["grad_norm"]), key
        for a, b in zip(tree.leaves(p), tree.leaves(base_p)):
            assert torch.equal(a, b), key
    m, _ = out["none", 2]
    assert float(m["loss"]) == pytest.approx(float(base_m["loss"]),
                                             rel=1e-6)
    assert float(m["grad_norm"]) == pytest.approx(
        float(base_m["grad_norm"]), rel=1e-5)


def _port_loop(tmp_path, steps, total=10):
    ts, p, o, _ = _port_setup("none", 1, total)
    pipe = SyntheticLM(512, S, B, seed=0)
    tcfg = TrainerConfig(steps=steps, ckpt_every=4, ckpt_dir=str(tmp_path))
    return ts, p, o, pipe, tcfg


def test_restart_resumes_identical_trajectory(tmp_path):
    """Kill-and-restart == uninterrupted run, bit for bit on the loss: the
    port's twin of the reference's test of the same name.  The restart
    gets new weights and moments, as a killed run would, so its
    trajectory can come only from the checkpoint."""
    full = train_loop(*_port_loop(tmp_path / "full", 10))
    ts, p, o, pipe, tcfg = _port_loop(tmp_path / "int", 10)
    first = train_loop(ts, p, o, pipe, dataclasses.replace(tcfg, steps=6))
    resumed = train_loop(*_port_loop(tmp_path / "int", 10))
    assert [h["step"] for h in first["history"]] == list(range(6))
    # the first run saved after steps 3 and 5: the restart begins at 6
    assert [h["step"] for h in resumed["history"]] == list(range(6, 10))
    losses = {h["step"]: h["loss"] for h in full["history"]}
    for h in first["history"] + resumed["history"]:
        assert h["loss"] == losses[h["step"]], h["step"]
    for a, b in zip(tree.leaves(full["params"]),
                    tree.leaves(resumed["params"])):
        assert torch.equal(a, b)
    for a, b in zip(tree.leaves(full["opt"]), tree.leaves(resumed["opt"])):
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))


def test_train_loop_matches_reference(tmp_path):
    """Ten steps of ``train_loop`` in both packages (the reference's
    driven by its step on the Auto-axis mesh): losses within 1e-5."""
    jts, jp, jo = _ref_setup("none", 1)
    ref = j_train_loop(jts, jp, jo, JSyntheticLM(512, S, B, seed=0),
                       JTrainerConfig(steps=10, ckpt_every=4,
                                      ckpt_dir=str(tmp_path / "ref")))
    got = train_loop(*_port_loop(tmp_path / "port", 10))
    assert len(got["history"]) == len(ref["history"]) == 10
    for g, r in zip(got["history"], ref["history"]):
        assert g["step"] == r["step"]
        assert g["loss"] == pytest.approx(r["loss"], rel=1e-5), g["step"]
    assert got["history"][-1]["loss"] < got["history"][0]["loss"]

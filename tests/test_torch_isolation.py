"""The PyTorch port stands alone: it imports neither ``jax`` nor the
reference package ``repro``, and its entry points never fall back to the
CPU on their own — without a card, a call that does not ask for
``device="cpu"`` raises."""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import repro_torch
names = ["repro_torch"] + [m.name for m in pkgutil.walk_packages(
    repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(len(names), bad, " ".join(names))
sys.exit(1 if bad else 0)
"""

#: the training slice's modules, each imported by the walk above
TRAINING_MODULES = (
    "repro_torch.tree", "repro_torch.optim.adamw",
    "repro_torch.optim.compress", "repro_torch.data.pipeline",
    "repro_torch.checkpoint.manager", "repro_torch.runtime.trainer",
    "repro_torch.launch.steps", "repro_torch.launch.mesh",
    "repro_torch.train_lm")

#: the mesh slice's modules: specs, meshes, cells
MESH_MODULES = ("repro_torch.parallel.sharding", "repro_torch.launch.cells")

#: the last slice's modules: the cost counter and the dry run
COSTING_MODULES = ("repro_torch.launch.costing", "repro_torch.launch.dryrun")


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
    names = set(proc.stdout.split("]", 1)[1].split())
    wanted = set(TRAINING_MODULES + MESH_MODULES + COSTING_MODULES)
    assert wanted <= names, sorted(wanted - names)
    # every module of the port was imported, the configs, models and
    # flash-attention modules, obs, the policy family, the sweep and the
    # sensor-fault models and guard included
    assert n_modules >= 80


def test_chip_smoke_imports_neither_jax_nor_reference():
    src = (ROOT / "chip_smoke.py").read_text()
    for word in ("import jax", "from jax", "import repro\n", "from repro ",
                 "from repro.", "import repro."):
        assert word not in src, word


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")


def test_entry_points_raise_without_a_card(no_card):
    from repro_torch.core.engine import APEngine
    from repro_torch.core.thermal import Grid
    from repro_torch.stack import feedback
    with pytest.raises(RuntimeError, match="cuda"):
        feedback.run_stack_cosim(workloads=("dmm",), n_dram=1, grid_n=4,
                                 n_intervals=2)
    with pytest.raises(RuntimeError, match="cuda"):
        APEngine(32, 8)
    with pytest.raises(RuntimeError, match="cuda"):
        Grid(die_w=1e-3, ny=4, nx=4).fields()
    with pytest.raises(RuntimeError, match="cuda"):
        Grid(die_w=1e-3, ny=4, nx=4).capacity_field()


def test_slice_two_entry_points_raise_without_a_card(no_card):
    """The steady solves, the transients, the §4 comparison and the
    multigrid replay raise unless they are asked for the CPU."""
    import numpy as np

    from repro_torch.core import floorplan, thermal
    from repro_torch.stack import feedback
    grid = thermal.Grid(die_w=1e-3, ny=8, nx=8)
    power = np.full((grid.n_die_layers, 8, 8), 1e-3, np.float32)
    for solver in thermal.SOLVERS:
        with pytest.raises(RuntimeError, match="cuda"):
            thermal.steady_state(power, grid, solver=solver)
    with pytest.raises(RuntimeError, match="cuda"):
        thermal.transient_solve_implicit(power, grid, 0.01, 2, solver="mg")
    with pytest.raises(RuntimeError, match="cuda"):
        thermal.transient_solve(power, grid, 1e-3)
    with pytest.raises(RuntimeError, match="cuda"):
        floorplan.thermal_comparison(grid_ap=64, grid_simd=16)
    with pytest.raises(RuntimeError, match="cuda"):
        floorplan.ap_block_zoom(floorplan.APFloorplan(), 4.0, grid_n=8)
    with pytest.raises(RuntimeError, match="cuda"):
        feedback.run_stack_cosim(workloads=("dmm",), n_dram=1, grid_n=4,
                                 n_intervals=2, solver="mg")


@pytest.mark.parametrize("name", ("deepseek-v2-lite-16b", "falcon-mamba-7b",
                                  "zamba2-1.2b", "whisper-base"))
def test_model_family_entry_points_raise_without_a_card(no_card, name):
    """Each model family's seeded weights and ``generate`` default to the
    card and raise without one; on the CPU they run."""
    from repro_torch import interop
    from repro_torch.configs import get_config
    from repro_torch.serve_lm import generate
    cfg = get_config(name).reduced()
    with pytest.raises(RuntimeError, match="cuda"):
        interop.lm_params_from_seed(cfg, 0)
    params = interop.lm_params_from_seed(cfg, 0, "cpu")
    extra = {}
    if cfg.family == "encdec":
        extra["audio_embeds"] = torch.zeros((1, cfg.enc_seq, cfg.d_model))
    tokens = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="cuda"):
        generate(params, tokens, cfg, 2, batch_extra=extra)
    assert generate(params, tokens, cfg, 2, device="cpu",
                    batch_extra=extra)["tokens"].shape == (1, 3)


def test_serving_cosim_raises_without_a_card(no_card):
    """``run_serving_cosim`` replays on the card unless it is given
    ``device="cpu"``; the shape-only parameter tree never touches a
    device, and ``resolve_device`` keeps rejecting ``"meta"`` for entry
    points."""
    from repro_torch import resolve_device
    from repro_torch.launch.steps import params_sds
    from repro_torch.serving import (ServingScenario, TrafficSpec,
                                     run_serving_cosim, serving_cost)
    sc = ServingScenario(config="stablelm-1.6b",
                         traffic=TrafficSpec(horizon_s=8.0), grid_n=4,
                         n_rounds=1)
    with pytest.raises(RuntimeError, match="cuda"):
        run_serving_cosim(sc)
    with pytest.raises(RuntimeError, match="cuda"):
        run_serving_cosim(sc, ("ap",))
    assert serving_cost("stablelm-1.6b").n_params > 0
    from repro_torch.configs import get_config
    assert all(l.device.type == "meta" for l in _tensors(
        params_sds(get_config("qwen2-vl-72b"))))
    with pytest.raises(ValueError, match="meta"):
        resolve_device("meta")
    reps = run_serving_cosim(sc, ("ap",), device="cpu")
    assert reps["ap"].n_base == 8


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _tensors(v)
    else:
        yield tree


def test_training_entry_points_raise_without_a_card(no_card, tmp_path):
    """The train step, its one-device mesh and ``train_lm`` default to the
    card and raise without one; with ``device="cpu"`` they run."""
    import dataclasses

    from repro_torch import train_lm
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_step
    cfg = dataclasses.replace(get_config("stablelm-1.6b").reduced(),
                              n_layers=1)
    cell = ShapeCell("t", 8, 2, "train")
    with pytest.raises(RuntimeError, match="cuda"):
        make_local_mesh(1, 1)
    mesh = make_local_mesh(1, 1, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        make_train_step(cfg, cell, mesh)
    # past 1 x 1 a mesh is a DeviceMesh over a process group of that size
    with pytest.raises(ValueError, match="process group"):
        make_local_mesh(2, 1, device="cpu")
    args = ["--steps", "2", "--width", "64", "--layers", "1", "--batch",
            "2", "--seq", "8", "--vocab", "256", "--ckpt-dir",
            str(tmp_path / "ck")]
    with pytest.raises(RuntimeError, match="cuda"):
        train_lm.main(args)
    out = train_lm.main(args + ["--device", "cpu"])
    assert [h["step"] for h in out["history"]] == [0, 1]


def test_serve_step_builders_raise_without_a_card(no_card):
    """The prefill and decode step builders default to the card and raise
    without one; with ``device="cpu"`` their steps run on the one-device
    mesh."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("h2o-danube-3-4b").reduced(),
                              n_layers=1)
    cell = ShapeCell("p", 8, 2, "prefill")
    mesh = make_local_mesh(1, 1, device="cpu")
    for build in (make_prefill_step, make_decode_step):
        with pytest.raises(RuntimeError, match="cuda"):
            build(cfg, cell, mesh)
    prefill, (psds, batch_sds) = make_prefill_step(cfg, cell, mesh,
                                                   device="cpu")
    decode, example = make_decode_step(cfg, cell, mesh, device="cpu")
    assert all(t.device.type == "meta" for t in
               [batch_sds["tokens"], *example[1:2], example[3]])
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    logits, caches = prefill(params, {"tokens": torch.zeros(
        (2, 8), dtype=torch.int32)})
    logits, caches = decode(params, logits.argmax(-1)[:, None], caches, 8)
    assert logits.shape == (2, M.vocab_padded(cfg))


def test_flash_backward_kernel_has_no_cpu_path():
    """``mha_backward`` is the hand-written kernel's wrapper alone: on CPU
    tensors it raises (autograd differentiates the plain ``ref.mha``
    there), so no training step can reach a plain stand-in through it."""
    from repro_torch.kernels.flash_attention import ops
    q = torch.zeros(1, 4, 2, 16)
    k = torch.zeros(1, 4, 1, 16)
    lse = torch.zeros(1, 2, 4)
    before = ops.mha_backward.launches
    with pytest.raises(ValueError, match="unsupported device"):
        ops.mha_backward(q, k, k, q, lse, q)
    assert ops.mha_backward.launches == before

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
print(len(names), bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_neither_jax_nor_reference():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    n_modules = int(proc.stdout.split()[0])
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

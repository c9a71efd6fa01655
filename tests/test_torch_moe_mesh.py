"""The MoE load-balance loss of a train step whose batch the data ranks
split, on CPU ``gloo`` worlds of spawned processes
(``_torch_worlds.run_world``).

The reference's Switch aux loss is built from the means of the token
and probability fractions over every dispatch group of the batch
(``src/repro/models/moe.py``), and XLA keeps those means global under
any sharding.  A data rank of the port's mesh step routes its own groups
only, so the step sums the fractions over the data axes, forward and
backward (``tensor_parallel.mean_over_data``); the mean of the ranks'
own aux losses would be another loss, with another router gradient.

Reduced deepseek-v2-lite-16b, the weights ``interop.lm_params_from_seed
(cfg, 0)``, tokens and labels [8, 32] from ``default_rng(1)``,
``remat="none"``, ``moe_groups=2``: on (data 2, model 1) and (data 2,
model 2) meshes the step's loss, aux loss and every gradient are within
1e-5 relative (normwise for the gradients) of the one-device step with
the same two groups.
"""
import pytest
import torch

from _torch_worlds import run_world

REL = 1e-5

_AUX = """
import numpy as np
from torch.distributed.tensor import DTensor
from repro_torch import interop, tree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import make_train_step
from repro_torch.models.model import PerfConfig

cfg = get_config("deepseek-v2-lite-16b").reduced()
rng = np.random.default_rng(1)
batch = {k: rng.integers(0, cfg.vocab, (1, 8, 32))
         for k in ("tokens", "labels")}
perf = PerfConfig(remat="none", moe_groups=2)
cell = ShapeCell("t", 32, 8, "train")
meshes = {"mesh": make_local_mesh(*ARGS["world"], device="cpu")}
if RANK == 0:
    meshes["one"] = (torch.device("cpu"),)
for name, m in meshes.items():
    ts, _ = make_train_step(cfg, cell, m, perf=perf, dtype=torch.float32,
                            device="cpu")
    g, loss, aux = ts.grads(interop.lm_params_from_seed(cfg, 0, "cpu"),
                            batch, with_aux=True)
    RESULT[name] = dict(
        loss=float(loss), aux=float(aux),
        grads={k: (v.full_tensor() if isinstance(v, DTensor) else v).clone()
               for k, v in tree.paths(g)})
"""


def _rel(got, want) -> float:
    return float((got - want).double().norm()
                 / want.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("world", [(2, 1), (2, 2)],
                         ids=lambda w: f"{w[0]}x{w[1]}")
def test_aux_loss_over_data_ranks_matches_one_device(tmp_path, world):
    ranks = run_world(tmp_path, world[0] * world[1], _AUX,
                      args={"world": world}, timeout=240)
    one = ranks[0]["one"]
    assert one["aux"] > 0
    for rank, res in enumerate(ranks):
        got = res["mesh"]
        for k in ("loss", "aux"):
            assert abs(got[k] - one[k]) <= REL * abs(one[k]), \
                (rank, k, got[k], one[k])
        assert got["grads"].keys() == one["grads"].keys()
        for k, v in one["grads"].items():
            assert _rel(got["grads"][k], v) <= REL, (rank, k)
    # the router's gradient holds the aux loss's term: it is not zero
    router = [k for k in one["grads"] if k.endswith("moe/router")]
    assert router and all(float(one["grads"][k].norm()) > 0
                          for k in router)

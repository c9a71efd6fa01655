"""The port's dry run (``launch/dryrun.py``) on the fake process group.

Each run on the fake group of 256 or 512 ranks goes in a subprocess, so
the pytest process keeps no default group.  The record is held to the
reference's schema key for key: its keys are read from the dict literal
``rec`` in ``src/repro/launch/dryrun.py`` (whose own CLI test fails on
this JAX: ROADMAP Queue 3's list of the reference's failures)."""
import ast
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def _dryrun(*args, timeout=300) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun",
                           *args], env=env, capture_output=True, text=True,
                          timeout=timeout)


def _schema(node) -> dict:
    """{key: nested schema or None} of a dict literal's string keys."""
    out = {}
    for k, v in zip(node.keys, node.values):
        if isinstance(k, ast.Constant):
            out[k.value] = _schema(v) if isinstance(v, ast.Dict) else None
    return out


def _reference_schema() -> dict:
    tree = ast.parse((ROOT / "src/repro/launch/dryrun.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and [getattr(t, "id", None) for t in node.targets] == ["rec"]:
            return _schema(node.value)
    raise AssertionError("no rec = {...} in the reference's dryrun.py")


def _keys_match(rec: dict, schema: dict, where="rec") -> None:
    assert sorted(rec) == sorted(schema), (where, sorted(rec),
                                           sorted(schema))
    for k, sub in schema.items():
        if sub:
            _keys_match(rec[k], sub, f"{where}.{k}")


def _finite_positive(rec: dict) -> None:
    for x in (rec["cost"]["flops"], rec["cost_raw_scan_once"]["flops"],
              rec["memory"]["peak_bytes_per_device"],
              rec["roofline"]["compute_s"], rec["roofline"]["memory_s"]):
        assert math.isfinite(x) and x > 0, rec


def test_cli_on_the_reference_test_cell_and_its_cache(tmp_path):
    """The reference's own CLI cell (whisper-base train_4k, 512 ranks):
    ``ALL CELLS PASSED``, the reference's record keys, a count of
    every kind of the step's collectives; a second call serves the
    cached record."""
    args = ("--arch", "whisper-base", "--shape", "train_4k", "--mesh",
            "multi", "--out", str(tmp_path))
    proc = _dryrun(*args, "--force")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ALL CELLS PASSED" in proc.stdout
    path = tmp_path / "pod2x16x16" / "whisper-base__train_4k.json"
    rec = json.loads(path.read_text())
    _keys_match(rec, _reference_schema())
    _finite_positive(rec)
    assert (rec["mesh"], rec["n_chips"], rec["kind"]) == \
        ("pod2x16x16", 512, "train")
    assert rec["perf"]["accum_steps"] == 8
    assert set(rec["cost_components"]) == {"enc_block", "dec_block"}
    # the weight gathers, the gradient reduce-scatters, the loss's mean
    coll = rec["collectives"]
    for kind in ("all-gather", "reduce-scatter", "all-reduce"):
        assert coll["counts"][kind] > 0 and coll[kind] > 0, kind
    assert coll["total_wire_bytes"] == rec["cost"]["wire_bytes"] > 0
    # each rank's rows on its heads, d_ff columns and vocabulary rows
    assert 0 < rec["roofline"]["useful_flop_ratio"] < 1
    stamp = path.stat().st_mtime_ns
    proc = _dryrun(*args)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "ALL CELLS PASSED" in proc.stdout
    assert path.stat().st_mtime_ns == stamp
    assert json.loads(path.read_text()) == rec


def test_decode_cell_with_the_int8_cache(tmp_path):
    """codeqwen1.5-7b decode_32k on 256 ranks, ``perf_for`` 's override
    (``kv_quant``): the int8 cache is half the bf16 one in the rank's
    arguments."""
    proc = _dryrun("--arch", "codeqwen1.5-7b", "--shape", "decode_32k",
                   "--mesh", "single", "--out", str(tmp_path), "--force")
    assert proc.returncode == 0, proc.stdout + proc.stderr
    rec = json.loads((tmp_path / "pod16x16" /
                      "codeqwen1.5-7b__decode_32k.json").read_text())
    _keys_match(rec, _reference_schema())
    _finite_positive(rec)
    assert rec["kind"] == "decode" and rec["roofline"]["dominant"] == "memory"
    from repro_torch.configs import SHAPES, get_config
    cfg, cell = get_config("codeqwen1.5-7b"), SHAPES["decode_32k"]
    # K and V, int8, of a rank's 8 sequences over the sequence's 16 model
    # shards, every layer
    kv = 2 * cfg.n_layers * (cell.global_batch // 16) * cell.seq_len \
        * cfg.n_kv_heads * cfg.head_dim // 16
    assert rec["memory"]["argument_bytes"] > kv
    assert rec["memory"]["argument_bytes"] < 2 * kv + 2 * 7.3e9 / 256 * 4


_GROUPS = r"""
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import dryrun
dryrun.fake_group(256)
assert dist.get_world_size() == 256
dryrun.fake_group(512)          # its own group: remade
assert dist.get_world_size() == 512
dryrun.release_group()
assert not dist.is_initialized()
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
try:
    dryrun.run_cell("whisper-base", "decode_32k", False, "unused")
except ValueError as e:
    assert "256" in str(e) and "8" in str(e), e
else:
    raise AssertionError("a group of 8 ranks was replaced")
assert dist.get_world_size() == 8
print("GROUPS OK")
"""


def test_the_fake_group_is_made_remade_and_never_replaces_another():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _GROUPS], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "GROUPS OK" in proc.stdout


def test_qwen2_vl_builds_and_counts_on_fake_tensors():
    """qwen2-vl-72b at full width: M-RoPE has no data-dependent shape,
    so its steps run on fake tensors (one device, no process group)."""
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch.cells import perf_for
    from repro_torch.launch.costing import ComponentCoster, step_cost
    cfg = get_config("qwen2-vl-72b")
    assert cfg.mrope_sections is not None
    for shape in ("prefill_32k", "decode_32k"):
        cell, perf = SHAPES[shape], perf_for("qwen2-vl-72b", shape)
        mesh = (torch.device("cpu"),)
        run = step_cost(cfg, cell, mesh, perf)
        rec = ComponentCoster(cfg, cell, mesh, perf).reconstruct(
            {"flops": run.cost["flops"],
             "bytes_accessed": run.cost["bytes"]}, run.cost["wire"])
        assert math.isfinite(run.cost["flops"]) and run.cost["flops"] > 0
        assert rec["per_component"]["block"]["true"] == cfg.n_layers
        assert run.cost["wire"] == 0          # one device: no collective


_TP_SPLIT = r"""
import json, sys
import torch
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.cells import default_perf
from repro_torch.launch.costing import ComponentCoster, step_cost
from repro_torch.launch.mesh import make_production_mesh
cfg, cell = get_config("stablelm-1.6b"), SHAPES["train_4k"]
perf = default_perf(cfg, cell, 16)
whole = step_cost(cfg, cell, (torch.device("cpu"),), perf)
dryrun.fake_group(256)
mesh = make_production_mesh()
rank = step_cost(cfg, cell, mesh, perf)
blocks = ComponentCoster(cfg, cell, mesh, perf).bodies()
print(json.dumps(dict(whole=whole.cost, rank=rank.cost,
                      coll=rank.collectives,
                      block_wire=blocks["block"][0]["wire"])))
"""


def test_tensor_parallel_rank_does_its_share_of_the_products():
    """stablelm-1.6b ``train_4k`` on the fake 256-rank group, with the 2D
    default of ``launch.cells`` (its own override is pure FSDP, which
    splits the batch over all 256 ranks and nothing over ``model``): a
    rank's product and attention flops times 256 are the one-device
    step's within 1 %, and the blocks' collectives over ``model`` carry
    wire bytes (forward sums and backward gradients, every layer and
    microbatch)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _TP_SPLIT], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    ratio = out["rank"]["matmul_flops"] * 256 / out["whole"]["matmul_flops"]
    assert abs(ratio - 1) <= 0.01, ratio
    assert out["block_wire"] > 0
    layers, accum = 24, 16
    assert out["coll"]["counts"]["all-reduce"] >= 4 * layers * accum
    assert out["coll"]["all-reduce"] > 0


_EP_SPLIT = r"""
import dataclasses, json, sys
import torch
from repro_torch.configs import SHAPES, get_config
from repro_torch.launch import dryrun
from repro_torch.launch.cells import default_perf
from repro_torch.launch.costing import ComponentCoster, step_cost
from repro_torch.launch.mesh import make_production_mesh
cell = SHAPES["train_4k"]
cuts = {"deepseek-v2-lite-16b": 2, "falcon-mamba-7b": 1}
cfgs = {a: dataclasses.replace(get_config(a), n_layers=n)
        for a, n in cuts.items()}
perfs = {a: dataclasses.replace(default_perf(get_config(a), cell, 16),
                                accum_steps=1) for a in cuts}
whole = {a: step_cost(c, cell, (torch.device("cpu"),), perfs[a]).cost
         for a, c in cfgs.items()}
dryrun.fake_group(256)
mesh = make_production_mesh()
out = {}
for a, c in cfgs.items():
    rank = step_cost(c, cell, mesh, perfs[a])
    blocks = ComponentCoster(c, cell, mesh, perfs[a]).bodies()
    out[a] = dict(whole=whole[a], rank=rank.cost, coll=rank.collectives,
                  perf=dataclasses.asdict(perfs[a]),
                  block_wire={k: v[0]["wire"] for k, v in blocks.items()})
print(json.dumps(out))
"""


def test_moe_and_ssm_ranks_do_their_share_of_the_products():
    """deepseek-v2-lite-16b (2 of 27 layers: the dense first and a MoE
    one) and falcon-mamba-7b (1 of 64) ``train_4k`` on the fake 256-rank
    group under the 2D default of ``launch.cells``, one microbatch (the
    default 16 split the same products 16 ways): a rank's product flops
    times 256 are the one-device step's, but for the products the
    reference's specs replicate over ``model`` (MLA's ``wkv_a``, the
    router), which each of the 16 ``model`` ranks runs whole for its
    rows: 4 times a forward product (remat's second forward, two
    backward products).
    falcon-mamba-7b replicates none.  Every block's collectives over
    ``model`` carry wire bytes, and no all-to-all is issued."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _EP_SPLIT], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    from repro_torch.configs import get_config
    cfg = get_config("deepseek-v2-lite-16b")
    d, m = cfg.d_model, cfg.mla
    tokens = 256 * 4096
    # wkv_a in both layers, the router in the MoE one
    replicated = 4 * tokens * (2 * 2 * d * (m.kv_lora + m.qk_rope)
                               + 2 * d * cfg.moe.n_routed)
    for arch, extra in (("deepseek-v2-lite-16b", replicated),
                        ("falcon-mamba-7b", 0)):
        r = out[arch]
        assert r["perf"]["parallelism"] == "2d"
        whole = r["whole"]["matmul_flops"]
        got = r["rank"]["matmul_flops"] * 256
        assert abs(got - (whole + 15 * extra)) <= 1e-6 * whole, \
            (arch, got / whole, (whole + 15 * extra) / whole)
        assert all(w > 0 for w in r["block_wire"].values()), r["block_wire"]
        assert r["coll"]["all-reduce"] > 0
        assert r["coll"]["counts"]["all-to-all"] == 0

"""The port's partition specs against the reference's, in process.

``make_sharder`` (both of them) in every combination, ``param_specs`` of
all ten configs at full size (the port's tree on ``"meta"``, the
reference's from ``jax.eval_shape``) on both mesh kinds, ``cache_specs``
and ``_retarget_cache_specs`` of every runnable prefill and decode cell
with its ``perf_for`` settings (codeqwen's int8 cache, the tiny-batch
``long_500k`` cells), and ``_batch_extras_sds``.  A reference
``PartitionSpec`` is compared as the tuple of its entries.

The port keeps a layer stack as a list of per-layer dicts, the reference
on a leading axis: a per-layer leaf's spec is the reference's without
its leading ``None``, and the port's rules given the reference's
stacked layout give the reference's specs themselves.

The spec placements on a ``DeviceMesh`` and the production meshes run
in a spawned process on the fake process group (256 and 512 ranks, one
process), so this process keeps no default group.
"""
import functools
import itertools
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec

from repro.launch import steps as jsteps
from repro.models import serve as JSV
from repro.parallel import sharding as jsharding
from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget_config
from repro_torch.configs import SHAPES, get_config, list_configs
from repro_torch.launch import steps
from repro_torch.launch.cells import perf_for, runnable_cells
from repro_torch.models import serve as SV
from repro_torch.parallel import sharding
from repro_torch.parallel.sharding import P, spec_paths

ROOT = Path(__file__).resolve().parents[1]


def _ref_specs(tree) -> dict:
    """``{"a/b/c": tuple}`` of a reference spec tree."""
    out = {}
    for path, s in jax.tree_util.tree_leaves_with_path(
            tree, is_leaf=lambda x: isinstance(x, PartitionSpec)):
        key = "/".join(str(getattr(k, "key", getattr(k, "name", k)))
                       for k in path)
        out[key] = tuple(s)
    return out


def _fields(shd) -> tuple:
    return shd.data_axes, shd.model_axes, shd.seq_axes


@pytest.mark.parametrize("multi_pod", [False, True])
def test_parallel_make_sharder_matches_reference(multi_pod):
    got = sharding.make_sharder(None, multi_pod)
    want = jsharding.make_sharder(None, multi_pod)
    assert _fields(got) == _fields(want)
    assert got.mesh is None


@pytest.mark.parametrize("multi_pod,tiny,par", list(itertools.product(
    [False, True], [False, True], ["2d", "fsdp"])))
def test_steps_make_sharder_matches_reference(multi_pod, tiny, par):
    got = steps.make_sharder(None, multi_pod, tiny_batch=tiny,
                             parallelism=par)
    want = jsteps.make_sharder(None, multi_pod, tiny_batch=tiny,
                               parallelism=par)
    assert _fields(got) == _fields(want)


def test_spec_is_a_tuple_and_pickles():
    import pickle
    s = P(("pod", "data"), None, "model")
    assert s == (("pod", "data"), None, "model")
    assert tuple(PartitionSpec(("pod", "data"), None, "model")) == s
    back = pickle.loads(pickle.dumps(s))
    assert back == s and isinstance(back, P)
    assert repr(s) == "P(('pod', 'data'), None, 'model')"


@functools.lru_cache(maxsize=None)
def _ref_param_specs(arch: str, multi_pod: bool) -> dict:
    cfg = jget_config(arch)
    psds = jsteps.params_sds(cfg)
    return psds, _ref_specs(jsharding.param_specs(cfg, psds, multi_pod))


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch", list_configs())
def test_param_specs_match_reference_leaf_for_leaf(arch, multi_pod):
    cfg = get_config(arch)
    _, want = _ref_param_specs(arch, multi_pod)
    got = spec_paths(sharding.param_specs(cfg, steps.params_sds(cfg),
                                          multi_pod))
    seen = set()
    for key, spec in got.items():
        parts = key.split("/")
        ref_key = "/".join(p for p in parts if not p.isdigit())
        ref = want[ref_key]
        if ref_key.split("/")[0] in sharding.STACK_KEYS:
            assert ref[0] is None, (key, ref)
            ref = ref[1:]
        assert isinstance(spec, P)
        assert tuple(spec) == ref, (key, spec, ref)
        seen.add(ref_key)
    assert seen == set(want)


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "zamba2-1.2b",
                                  "whisper-base"])
def test_param_specs_of_a_stacked_tree_carry_the_layer_prefix(arch):
    """The port's rules on the reference's layout (a leading layer axis,
    no list index): the reference's specs, prefix included."""
    psds, want = _ref_param_specs(arch, False)
    meta = jax.tree_util.tree_map(
        lambda s: torch.empty(s.shape, device="meta"), psds)
    got = spec_paths(sharding.param_specs(get_config(arch), meta))
    assert {k: tuple(v) for k, v in got.items()} == want


def _serve_cells():
    out = []
    for arch, shape in runnable_cells():
        if SHAPES[shape].kind in ("prefill", "decode"):
            out.append((arch, shape))
    return out


@pytest.mark.parametrize("multi_pod", [False, True])
@pytest.mark.parametrize("arch,shape", _serve_cells())
def test_cache_specs_and_retargeting_match_reference(arch, shape,
                                                     multi_pod):
    cfg, jcfg = get_config(arch), jget_config(arch)
    cell = SHAPES[shape]
    perf = perf_for(arch, shape)
    B, S = cell.global_batch, cell.seq_len
    tiny = B < 16
    csds = SV.init_caches(cfg, B, S, torch.bfloat16,
                          kv_quant=perf.kv_quant, device="meta")
    jcsds = jax.eval_shape(functools.partial(
        JSV.init_caches, jcfg, B, S, jnp.bfloat16, kv_quant=perf.kv_quant))
    got = sharding.cache_specs(cfg, csds, multi_pod)
    want = jsharding.cache_specs(jcfg, jcsds, multi_pod)
    assert {k: tuple(v) for k, v in spec_paths(got).items()} == \
        _ref_specs(want)
    shd = steps.make_sharder(None, multi_pod, tiny_batch=tiny)
    jshd = jsteps.make_sharder(None, multi_pod, tiny_batch=tiny)
    got_r = spec_paths(steps._retarget_cache_specs(got, shd))
    want_r = _ref_specs(jsteps._retarget_cache_specs(want, jshd))
    assert {k: tuple(v) for k, v in got_r.items()} == want_r
    if perf.kv_quant:
        assert "layers/k_q" in got_r


@pytest.mark.parametrize("arch", ["whisper-base", "qwen2-vl-72b"])
@pytest.mark.parametrize("lead", [(4,), (2, 8)])
def test_batch_extras_match_reference(arch, lead):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for data in ("data", ("pod", "data"), None):
        sds, specs = steps._batch_extras_sds(cfg, lead, torch.bfloat16,
                                             data)
        jsds, jspecs = jsteps._batch_extras_sds(jcfg, lead, jnp.bfloat16,
                                                data)
        assert sorted(sds) == sorted(jsds) and sds
        for k in sds:
            assert tuple(sds[k].shape) == jsds[k].shape
            assert sds[k].device.type == "meta"
            assert sds[k].dtype == torch.bfloat16
            assert tuple(specs[k]) == tuple(jspecs[k])


def test_every_shape_cell_is_the_reference_s():
    assert {k: (c.seq_len, c.global_batch, c.kind)
            for k, c in SHAPES.items()} == \
        {k: (c.seq_len, c.global_batch, c.kind)
         for k, c in JSHAPES.items()}


_FAKE_MESHES = r"""
import torch, torch.distributed as dist
from torch.distributed.tensor import Replicate, Shard
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
from repro_torch.parallel.sharding import P, to_named, placements
out = []
for world, multi in ((256, False), (512, True)):
    dist.init_process_group("fake", store=FakeStore(), rank=3,
                            world_size=world)
    mesh = make_production_mesh(multi_pod=multi)
    out.append((world, tuple(mesh.shape), mesh.mesh_dim_names,
                mesh.device_type))
    if multi:
        ns = to_named(mesh, {"w": P(("pod", "data"), "model"),
                             "b": P("model"), "r": P(None, None)})
        assert ns["w"].placements == (Shard(0), Shard(0), Shard(1))
        assert ns["b"].placements == (Replicate(), Replicate(), Shard(0))
        assert ns["r"].placements == (Replicate(),) * 3
        for bad in (P(("data", "pod")), P("data", "data"), P("rows")):
            try:
                placements(mesh, bad)
            except ValueError:
                pass
            else:
                raise AssertionError(bad)
    else:
        try:
            make_production_mesh(multi_pod=True)
        except ValueError as e:
            assert "512" in str(e)
        else:
            raise AssertionError("a 512-rank mesh on 256 ranks")
        try:
            make_local_mesh(4, 2, device="cpu")
        except ValueError as e:
            assert "8" in str(e)
        else:
            raise AssertionError("a 4 x 2 mesh on 256 ranks")
    dist.destroy_process_group()
print("MESHES", out)
"""


def test_production_meshes_and_placements_on_the_fake_group():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", _FAKE_MESHES], env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    line = [x for x in proc.stdout.splitlines() if x.startswith("MESHES")]
    assert line == ["MESHES [(256, (16, 16), ('data', 'model'), 'cpu'), "
                    "(512, (2, 16, 16), ('pod', 'data', 'model'), 'cpu')]"]


def test_meshes_need_a_process_group():
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_local_mesh, make_production_mesh
    assert not dist.is_initialized()
    for multi in (False, True):
        with pytest.raises(ValueError, match="process group"):
            make_production_mesh(multi_pod=multi)
    with pytest.raises(ValueError, match="2 ranks"):
        make_local_mesh(1, 2, device="cpu")
    assert make_local_mesh(1, 1, device="cpu") == (torch.device("cpu"),)

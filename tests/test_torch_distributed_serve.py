"""The prefill and decode steps on a ``DeviceMesh`` and the elastic
re-mesh restore, on CPU ``gloo`` worlds of spawned processes
(``_torch_worlds.run_world``).

Prefill and decode run on a (data 2, model 2) mesh for a dense config
(h2o-danube-3-4b: ``k``, ``v``, ``slot_pos``) and the hybrid (zamba2-1.2b:
``conv`` and ``h`` beside the shared block's ``k``, ``v``), reduced, the
weights ``interop.lm_params_from_seed(cfg, 0)``, at 16 sequences (the
batch split over ``data``) and at 4 (under 16: the tiny-batch rule, the
sequence over the whole mesh).  Both run tensor-parallel over ``model``
(``parallel/tensor_parallel.py``): their row-parallel products sum the
ranks' partial sums, in another order than one device adds, so their
logits and caches are held to the one-device step's within ``ATOL`` and
their greedy tokens equal.  Both are placed as the
reference's output specs say; the one-device step at 4 sequences is
held to the reference's ``models.serve.prefill`` / ``decode_step``
within ``tests/test_torch_lm_serve.py`` 's 1e-4.

The re-mesh restore is the reference test's tree: saved from a (4, 2)
world of 8, restored onto (2, 2) in a world of 4 and onto one device,
bit for bit, each leaf placed by its spec; a file the reference's own
``save`` wrote from its (4, 2) mesh restores onto (2, 2) the same way.
"""
import numpy as np
import pytest
import torch

from _torch_worlds import finish, run_reference, run_world

ATOL = 1e-4
S = 24          # prompt length = the cell's sequence length

_SERVE = """
import numpy as np
from torch.distributed.tensor import DTensor
from repro_torch import interop, tree
from repro_torch.configs import get_config
from repro_torch.configs.base import ShapeCell
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import make_decode_step, make_prefill_step

cfg = get_config(ARGS["arch"]).reduced()
params = interop.lm_params_from_seed(cfg, 0, "cpu")
mesh = make_local_mesh(2, 2, device="cpu")
one = (torch.device("cpu"),)


def whole(t):
    return {k: (v.full_tensor() if isinstance(v, DTensor) else v).clone()
            for k, v in tree.paths(t)}


for B in ARGS["batches"]:
    S = ARGS["S"]
    tokens = np.random.default_rng(B).integers(0, cfg.vocab, (B, S))
    cell = ShapeCell("p", S, B, "prefill")
    out = {}
    for name, m in ({"mesh": mesh, "one": one} if RANK == 0
                    else {"mesh": mesh}).items():
        prefill, _ = make_prefill_step(cfg, cell, m, dtype=torch.float32,
                                       device="cpu")
        decode, _ = make_decode_step(cfg, ShapeCell("d", S, B, "decode"), m,
                                     dtype=torch.float32, device="cpu")
        logits, caches = prefill(params, {"tokens": tokens})
        r = {"logits": whole({"x": logits})["x"], "caches": whole(caches)}
        if name == "mesh":
            r["placed"] = tuple(logits.placements)
            r["cache_placed"] = {k: tuple(v.placements)
                                 for k, v in tree.paths(caches)}
        nxt = r["logits"].argmax(-1)[:, None]
        logits, caches = decode(params, nxt, caches, S)
        r.update(next=nxt, dec_logits=whole({"x": logits})["x"],
                 dec_caches=whole(caches))
        if name == "mesh":
            r["dec_placed"] = tuple(logits.placements)
            r["dec_cache_placed"] = {k: tuple(v.placements)
                                     for k, v in tree.paths(caches)}
        out[name] = r
    RESULT[B] = out
"""


def _reference(arch: str, B: int):
    """The reference's prefill and first decode step of the world's
    batch, from the same seeded weights."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import serve as RS
    from repro_torch import interop
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    jc = jget_config(arch).reduced()
    p = jax.tree_util.tree_map(jnp.asarray,
                               interop.lm_params_seed_numpy(cfg, 0))
    tokens = np.random.default_rng(B).integers(0, cfg.vocab, (B, S))
    logits, caches = RS.prefill(p, {"tokens": jnp.asarray(tokens)}, jc,
                                max_seq=S)
    nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
    dec, _ = RS.decode_step(p, nxt, caches, S, jc)
    return np.asarray(logits), np.asarray(nxt), np.asarray(dec)


def _expected_placements(arch: str, B: int, mesh_dims=("data", "model")):
    """The reference's output specs of the world's cell, as placements
    on a (2, 2) mesh (worked out here without a mesh)."""
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.configs import get_config
    from repro_torch.launch.steps import _retarget_cache_specs, make_sharder
    from repro_torch.models import serve as SV
    from repro_torch.parallel.sharding import P, cache_specs, spec_paths
    cfg = get_config(arch).reduced()
    shd = make_sharder(None, False, tiny_batch=B < 16)
    specs = spec_paths(_retarget_cache_specs(cache_specs(
        cfg, SV.init_caches(cfg, B, S, device="meta")), shd))
    specs["logits"] = P(shd.data_axes, "model")

    def placed(spec):
        out = [Replicate()] * len(mesh_dims)
        for d, entry in enumerate(spec):
            names = () if entry is None else (
                (entry,) if isinstance(entry, str) else entry)
            for a in names:
                out[mesh_dims.index(a)] = Shard(d)
        return tuple(out)
    return {k: placed(v) for k, v in specs.items()}


@pytest.mark.parametrize("arch", ["h2o-danube-3-4b", "zamba2-1.2b"])
def test_mesh_prefill_decode_match_one_device(tmp_path, arch):
    batches = (16, 4)
    ranks = run_world(tmp_path, 4, _SERVE, timeout=240,
                      args={"arch": arch, "batches": batches, "S": S})
    # both configs split over "model": their sums run in another order
    def same(a, b):
        return torch.allclose(a, b, rtol=0, atol=ATOL)
    for B in batches:
        want_pl = _expected_placements(arch, B)
        one = ranks[0][B]["one"]
        for rank, res in enumerate(ranks):
            got = res[B]["mesh"]
            assert got["placed"] == got["dec_placed"] == want_pl["logits"]
            for pl in ("cache_placed", "dec_cache_placed"):
                assert got[pl] == {k: v for k, v in want_pl.items()
                                   if k != "logits"}, (rank, B, pl)
            assert torch.equal(got["next"], one["next"]), (rank, B)
            for k in ("logits", "dec_logits"):
                assert same(got[k], one[k]), (rank, B, k)
            for k in ("caches", "dec_caches"):
                assert got[k].keys() == one[k].keys()
                for leaf, v in one[k].items():
                    assert same(got[k][leaf], v), (rank, B, k, leaf)
    # the one-device step against the reference at the tiny batch (the
    # 16-sequence batch runs the same code on more rows)
    one = ranks[0][4]["one"]
    logits, nxt, dec = _reference(arch, 4)
    np.testing.assert_allclose(one["logits"].numpy(), logits, rtol=0,
                               atol=ATOL)
    assert np.array_equal(one["next"].numpy(), nxt)
    np.testing.assert_allclose(one["dec_logits"].numpy(), dec, rtol=0,
                               atol=ATOL)


_TREE = """
tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
        "v": torch.arange(16, dtype=torch.float32)}
specs = {"w": P("data", "model"), "v": P("model")}
"""

_SAVE = """
from repro_torch.checkpoint import save
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.parallel.sharding import P, place, to_named
""" + _TREE + """
mesh = make_local_mesh(4, 2, device="cpu")
sharded = place(tree, to_named(mesh, specs))
RESULT["local"] = {k: v.to_local().clone() for k, v in sharded.items()}
save(ARGS["dir"], 1, sharded)
"""

_RESTORE = """
from repro_torch.checkpoint import restore
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.parallel.sharding import P, to_named
""" + _TREE + """
mesh = make_local_mesh(2, 2, device="cpu")
target = {k: torch.empty(v.shape, device="meta") for k, v in tree.items()}
want = {k: v.placements for k, v in to_named(mesh, specs).items()}
for which, d in ARGS["dirs"].items():
    out = restore(d, 1, target, mesh=mesh, specs=specs)
    RESULT[which] = {
        k: dict(full=v.full_tensor(), local=v.to_local().clone(),
                placed=tuple(v.placements) == want[k],
                mesh=tuple(v.device_mesh.shape))
        for k, v in out.items()}
"""

_REF_SAVE = r"""
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P, NamedSharding
from repro.checkpoint import save

tree = {"w": jnp.arange(64, dtype=jnp.float32).reshape(8, 8),
        "v": jnp.arange(16, dtype=jnp.float32)}
specs = {"w": P("data", "model"), "v": P("model")}
mesh = jax.make_mesh((4, 2), ("data", "model"))
save(DIR, 1, {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
              for k, v in tree.items()})
"""


def test_elastic_remesh_restore(tmp_path):
    from repro_torch.checkpoint import restore
    from repro_torch.checkpoint.manager import latest_step
    port_dir, ref_dir = tmp_path / "port", tmp_path / "ref"
    ref = run_reference(_REF_SAVE.replace("DIR", repr(str(ref_dir))))
    saved = run_world(tmp_path, 8, _SAVE, name="save",
                      args={"dir": str(port_dir)}, timeout=90)
    finish(ref)
    assert latest_step(port_dir) == latest_step(ref_dir) == 1
    tree = {"w": torch.arange(64, dtype=torch.float32).reshape(8, 8),
            "v": torch.arange(16, dtype=torch.float32)}
    # (4, 2): rank r holds its (data, model) = (r // 2, r % 2) block
    for r, res in enumerate(saved):
        i, j = divmod(r, 2)
        assert torch.equal(res["local"]["w"], tree["w"][2 * i:2 * i + 2,
                                                        4 * j:4 * j + 4])
        assert torch.equal(res["local"]["v"], tree["v"][8 * j:8 * j + 8])
    ranks = run_world(tmp_path, 4, _RESTORE, name="restore", timeout=90,
                      args={"dirs": {"port": str(port_dir),
                                     "ref": str(ref_dir)}})
    for r, res in enumerate(ranks):
        i, j = divmod(r, 2)
        for which in ("port", "ref"):
            got = res[which]
            for k, v in tree.items():
                assert torch.equal(got[k]["full"], v), (r, which, k)
                assert got[k]["placed"] and got[k]["mesh"] == (2, 2)
            assert torch.equal(got["w"]["local"], tree["w"][4 * i:4 * i + 4,
                                                            4 * j:4 * j + 4])
            assert torch.equal(got["v"]["local"], tree["v"][8 * j:8 * j + 8])
    # onto one device, no process group
    target = {k: torch.empty(v.shape, device="meta") for k, v in tree.items()}
    for d in (port_dir, ref_dir):
        out = restore(d, 1, target, device="cpu")
        for k, v in tree.items():
            assert torch.equal(out[k], v), (d, k)

"""Tensor-parallel compute over ``model`` (``parallel/tensor_parallel.py``)
on CPU ``gloo`` worlds of spawned processes (``_torch_worlds.run_world``).

The dense and encdec families split their heads, ``d_ff`` and vocabulary
over the mesh axis ``model``, as the reference's specs and activation
hooks make XLA split them.  Each world is a (data, model) mesh of
(1, 2), (2, 2) or (1, 4) ranks running the reduced configs of
stablelm-1.6b, h2o-danube-3-4b (1 KV head, fewer than the ``model``
ranks, and a 64-slot window that the prompt passes), qwen2-vl-72b
(M-RoPE, prefix embeddings, 1 KV head, QKV biases) and whisper-base,
with the weights ``interop.lm_params_seed_numpy(cfg, 0)`` on every side:

- train: two microbatches of 4 sequences through ``make_train_step`` 's
  gradient (``train_step.grads``): the loss within 1e-5 relative and
  each gradient's ``full_tensor()`` within 1e-5 normwise of the
  one-device step's;
- serve: prefill of 16 sequences (the batch over ``data``) and of 4 (a
  tiny batch: the cache sequence over the whole mesh), then 4 greedy
  decode steps, the tokens from the vocabulary-split logits
  (``tensor_parallel.greedy``): logits within ``ATOL`` of JAX's
  ``models.serve`` on the same parameters and of the one-device step's,
  every greedy token JAX's, the caches placed by the reference's specs;
  danube's int8 cache within ``INT8_ATOL`` with the same tokens
  (``tests/test_torch_lm_serve.py`` gives the bound's cause);
- layout: a rank holds 1/m of every split weight where heads divide,
  only the KV projections of a config with fewer KV heads than ranks are
  gathered whole over ``model``, and a stablelm step on a (1, m) mesh
  issues no all-gather but those of the decode activations.

The one-device step runs here, in the test's process, on the same
functions (``_train_run``, ``_serve_run``) the ranks run.  The
row-parallel products sum the ranks' partial sums in another order than
one device adds, so nothing here is bit for bit.
"""
import inspect

import numpy as np
import pytest
import torch

from _torch_worlds import run_world

ARCHS = ("stablelm-1.6b", "h2o-danube-3-4b", "qwen2-vl-72b", "whisper-base")
#: the int8 cache's runs: danube (GQA, a window) at the split batch
INT8 = (("h2o-danube-3-4b", 16),)
WORLDS = ((1, 2), (2, 2), (1, 4))
ATOL = 1e-4
INT8_ATOL = 5e-3
REL = 1e-5
BATCHES = (16, 4)
N_DEC = 4
#: (cache length, prompt length); danube's prompt passes its window
LENGTHS = {"h2o-danube-3-4b": (80, 72)}


def _lengths(arch: str) -> tuple[int, int]:
    return LENGTHS.get(arch, (32, 24))


def _inputs(arch: str, B: int, S: int, seed: int, lead=()) -> dict:
    """The batch's arrays besides labels: tokens [*lead, B, S] and the
    family's embeddings, from ``seed``."""
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, lead + (B, S))}
    if cfg.family == "encdec":
        out["audio_embeds"] = rng.normal(size=lead + (
            B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_prefix_embeds:
        out["prefix_embeds"] = rng.normal(size=lead + (
            B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return out


def _train_run(cfg, mesh, batch) -> dict:
    """``make_train_step`` 's gradient of ``batch`` (two microbatches) on
    ``mesh``: the loss, each gradient whole, the all-gathers issued;
    on a ``DeviceMesh`` also the layout and the rank's tensors' shapes.
    Runs in a world's ranks and, on the one-device mesh, here."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import interop, tree
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.costing import CostCounter
    from repro_torch.launch.steps import make_train_step, params_sds
    from repro_torch.models.model import PerfConfig
    from repro_torch.parallel.sharding import (gather, is_device_mesh,
                                               param_specs, place, to_named)
    params = interop.lm_params_from_seed(cfg, 0, "cpu")
    cell = ShapeCell("t", batch["tokens"].shape[-1], 8, "train")
    ts, _ = make_train_step(cfg, cell, mesh,
                            perf=PerfConfig(remat="full", accum_steps=2),
                            dtype=torch.float32, device="cpu")
    with CostCounter() as c:
        g, loss = ts.grads(params, batch)
    out = dict(loss=float(loss), all_gathers=c.counts["all-gather"],
               grads={k: (v.full_tensor() if isinstance(v, DTensor)
                          else v).clone() for k, v in tree.paths(g)})
    if is_device_mesh(mesh):
        out["layout"] = dict(tree.paths(ts.layout))
        pnamed = to_named(mesh, param_specs(cfg, params_sds(cfg)))
        local = gather(place(params, pnamed), "model", ts.layout)
        out["local"] = {k: tuple(v.shape) for k, v in tree.paths(local)}
    return out


def _serve_run(cfg, mesh, L, batch, quant, n_dec) -> dict:
    """A prefill of ``batch`` with caches of ``L`` slots and ``n_dec``
    greedy decode steps through the step builders on ``mesh``: each
    step's logits whole, the greedy tokens, the all-gathers of each
    step, the caches whole; on a ``DeviceMesh`` also the placements.
    Runs in a world's ranks and, on the one-device mesh, here."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import interop, tree
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.costing import CostCounter
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models.model import PerfConfig
    from repro_torch.parallel import tensor_parallel as TP
    from repro_torch.parallel.sharding import is_device_mesh

    def whole(x):
        return (x.full_tensor() if isinstance(x, DTensor) else x).clone()
    params = interop.lm_params_from_seed(cfg, 0, "cpu")
    perf = PerfConfig(kv_quant=quant)
    B, pos = batch["tokens"].shape
    prefill, _ = make_prefill_step(cfg, ShapeCell("p", L, B, "prefill"),
                                   mesh, perf=perf, dtype=torch.float32,
                                   device="cpu")
    decode, _ = make_decode_step(cfg, ShapeCell("d", L, B, "decode"), mesh,
                                 perf=perf, dtype=torch.float32,
                                 device="cpu")
    r = {"logits": [], "tokens": [], "gathers": []}
    with CostCounter() as c:
        logits, caches = prefill(params, batch)
    r["gathers"].append(c.counts["all-gather"])
    if is_device_mesh(mesh):
        r["placed"] = {k: tuple(v.placements) for k, v in tree.paths(caches)}
        r["placed"]["logits"] = tuple(logits.placements)
    for t in range(n_dec + 1):
        r["logits"].append(whole(logits))
        if is_device_mesh(mesh):
            nxt = TP.greedy(logits)
        else:
            nxt = logits.argmax(-1)[:, None].to(torch.int32)
        r["tokens"].append(whole(nxt))
        if t == n_dec:
            break
        with CostCounter() as c:
            logits, caches = decode(params, nxt, caches, pos + t)
        r["gathers"].append(c.counts["all-gather"])
    r["caches"] = {k: whole(v) for k, v in tree.paths(caches)}
    return r


_PRELUDE = """
import numpy as np
from torch.distributed.tensor import DTensor
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.parallel import tensor_parallel as TP
from repro_torch.parallel.sharding import NamedSharding, P

mesh = make_local_mesh(*ARGS["world"], device="cpu")
data = dict(np.load(ARGS["inputs"]))


def batch_of(key):
    return {k.split(":")[-1]: v for k, v in data.items()
            if k.startswith(key + ":")}
"""

_TRAIN = _PRELUDE + inspect.getsource(_train_run) + """
for arch in ARGS["archs"]:
    RESULT[arch] = _train_run(get_config(arch).reduced(), mesh,
                              batch_of(arch))
"""

_SERVE = _PRELUDE + inspect.getsource(_serve_run) + """
for arch in ARGS["archs"]:
    cfg = get_config(arch).reduced()
    for B in ARGS["batches"]:
        for quant in (False, True) if (arch, B) in ARGS["int8"] \
                else (False,):
            RESULT[(arch, B, quant)] = _serve_run(
                cfg, mesh, ARGS["lengths"][arch],
                batch_of(f"{arch}:{B}"), quant, ARGS["n_dec"])

# greedy ties: the same largest value at vocabulary rows 3 and 300 of
# every sequence, rows in different ranks' columns at every width here
V = 512
i_data, i_model = mesh.get_coordinate()
n_data, n_model = mesh.size(0), mesh.size(1)
rows, cols = 16 // n_data, V // n_model
tied = torch.zeros(16, V)
tied[:, 3] = tied[:, 300] = 7.0
local = tied[i_data * rows:(i_data + 1) * rows,
             i_model * cols:(i_model + 1) * cols].contiguous()
tied = DTensor.from_local(local, mesh,
                          NamedSharding(mesh, P("data", "model")).placements,
                          run_check=False, shape=(16, V), stride=(V, 1))
RESULT["ties"] = TP.greedy(tied).full_tensor()
"""

_WORLDS: dict = {}


def _train_inputs(arch: str) -> dict:
    inputs = _inputs(arch, 4, _lengths(arch)[1], 1, lead=(2,))
    inputs["labels"] = np.random.default_rng(2).integers(
        0, 512, inputs["tokens"].shape)
    return inputs


def _world(kind: str, world: tuple, tmp_path_factory) -> list[dict]:
    """The ranks' results of the ``kind`` world on a ``world`` mesh, run
    once for the module's tests."""
    key = (kind, world)
    if key not in _WORLDS:
        tmp = tmp_path_factory.mktemp(f"{kind}_{world[0]}x{world[1]}")
        arrays = {}
        for arch in ARCHS:
            if kind == "train":
                arrays.update({f"{arch}:{k}": v for k, v in
                               _train_inputs(arch).items()})
                continue
            for B in BATCHES:
                arrays.update({f"{arch}:{B}:{k}": v for k, v in
                               _inputs(arch, B, _lengths(arch)[1],
                                       B).items()})
        np.savez(tmp / "inputs.npz", **arrays)
        args = {"world": world, "archs": ARCHS, "inputs":
                str(tmp / "inputs.npz"), "batches": BATCHES,
                "n_dec": N_DEC, "int8": INT8,
                "lengths": {a: _lengths(a)[0] for a in ARCHS}}
        _WORLDS[key] = run_world(tmp, world[0] * world[1],
                                 _TRAIN if kind == "train" else _SERVE,
                                 args=args, timeout=900, name=kind)
    return _WORLDS[key]


_ONE: dict = {}


def _one_device(kind: str, arch: str, B: int = 0, quant: bool = False):
    """The one-device step's results of what the worlds run, here."""
    from repro_torch.configs import get_config
    key = (kind, arch, B, quant)
    if key not in _ONE:
        cfg, one = get_config(arch).reduced(), (torch.device("cpu"),)
        if kind == "train":
            _ONE[key] = _train_run(cfg, one, _train_inputs(arch))
        else:
            _ONE[key] = _serve_run(
                cfg, one, _lengths(arch)[0],
                _inputs(arch, B, _lengths(arch)[1], B), quant, N_DEC)
    return _ONE[key]


def _rel(got, want) -> float:
    return float((got - want).double().norm()
                 / want.double().norm().clamp_min(1e-30))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_train_gradients_match_one_device(world, arch, tmp_path_factory):
    ranks = _world("train", world, tmp_path_factory)
    one = _one_device("train", arch)
    for rank, res in enumerate(ranks):
        got = res[arch]
        assert abs(got["loss"] - one["loss"]) <= REL * abs(one["loss"]), \
            (rank, got["loss"], one["loss"])
        assert got["grads"].keys() == one["grads"].keys()
        for k, v in one["grads"].items():
            assert _rel(got["grads"][k], v) <= REL, (rank, k)


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_a_rank_holds_its_share_of_each_split_weight(world,
                                                     tmp_path_factory):
    """Where heads divide by the ``model`` size, a rank's tensor of every
    weight the specs split over ``model`` is 1/m of it on that axis; a
    config with fewer KV heads than ranks gathers its KV projections
    (and only them) whole; on a (1, m) mesh, where the data axis gathers
    nothing, a stablelm gradient issues no all-gather at all."""
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import params_sds
    from repro_torch.parallel.sharding import param_specs, spec_paths
    m = world[1]
    ranks = _world("train", world, tmp_path_factory)
    for arch in ARCHS:
        cfg = get_config(arch).reduced()
        psds = params_sds(cfg, torch.float32)
        shapes = {k: tuple(v.shape) for k, v in spec_paths(psds).items()}
        specs = spec_paths(param_specs(cfg, psds))
        for res in ranks:
            layout, local = res[arch]["layout"], res[arch]["local"]
            whole = {k for k, v in layout.items() if v == "whole"}
            want_whole = set() if cfg.n_kv_heads % m == 0 else {
                k for k in layout if k.split("/")[-1] in
                ("wk", "wv", "bk", "bv")}
            assert whole == want_whole, (arch, sorted(whole))
            for k, kind in layout.items():
                if kind != "shard":
                    assert local[k] == shapes[k], (arch, k)
                    continue
                dim = list(specs[k]).index("model") if "model" in specs[k] \
                    else next(i for i, e in enumerate(specs[k])
                              if e and "model" in e)
                want = list(shapes[k])
                want[dim] //= m
                assert local[k] == tuple(want), (arch, k, local[k])
            if world[0] == 1 and arch == "stablelm-1.6b":
                assert res[arch]["all_gathers"] == 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_prefill_decode_match_reference(world, arch, tmp_path_factory):
    from test_torch_distributed_serve import _expected_placements
    ranks = _world("serve", world, tmp_path_factory)
    for B in BATCHES:
        want_logits, want_tokens = _reference(arch, B)
        want_pl = _expected_placements(arch, B)
        one = _one_device("serve", arch, B)
        for rank, res in enumerate(ranks):
            got = res[(arch, B, False)]
            assert got["placed"] == want_pl, (rank, B)
            for t, (a, b, w) in enumerate(zip(got["logits"], one["logits"],
                                              want_logits)):
                np.testing.assert_allclose(a.numpy(), w, rtol=0, atol=ATOL,
                                           err_msg=f"rank {rank} B {B} {t}")
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                           atol=ATOL)
            for a, b, w in zip(got["tokens"], one["tokens"], want_tokens):
                assert torch.equal(a, b) and np.array_equal(a.numpy(), w)
            assert got["caches"].keys() == one["caches"].keys()
            for k, v in one["caches"].items():
                np.testing.assert_allclose(
                    got["caches"][k].numpy(), v.numpy(), rtol=0, atol=ATOL,
                    err_msg=f"{rank} {B} {k}")
            if world[0] == 1 and arch == "stablelm-1.6b":
                # K and V of each layer in prefill; q, K and V in decode
                n = get_layers(arch)
                assert got["gathers"] == [2 * n] + [3 * n] * N_DEC


@pytest.mark.parametrize("arch, B", INT8)
@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_int8_cache_decode_matches_one_device(world, arch, B,
                                              tmp_path_factory):
    ranks = _world("serve", world, tmp_path_factory)
    one = _one_device("serve", arch, B, quant=True)
    _, want_tokens = _reference(arch, B, kv_quant=True)
    for rank, res in enumerate(ranks):
        got = res[(arch, B, True)]
        for a, b in zip(got["logits"], one["logits"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=INT8_ATOL)
        for a, b, w in zip(got["tokens"], one["tokens"], want_tokens):
            assert torch.equal(a, b) and np.array_equal(a.numpy(), w)
        assert got["caches"]["layers/k_q"].dtype == torch.int8


@pytest.mark.parametrize("world", WORLDS, ids=lambda w: f"{w[0]}x{w[1]}")
def test_greedy_ties_go_to_the_lowest_index(world, tmp_path_factory):
    for res in _world("serve", world, tmp_path_factory):
        assert torch.equal(res["ties"], torch.full((16, 1), 3,
                                                   dtype=torch.int32))


def get_layers(arch: str) -> int:
    from repro_torch.configs import get_config
    return get_config(arch).reduced().n_layers


_REF: dict = {}


def _reference(arch: str, B: int, kv_quant: bool = False):
    """JAX's prefill and ``N_DEC`` greedy decode steps of the serve
    world's batch, on the same seeded parameters: (logits of each step,
    greedy tokens [B, 1] of each step)."""
    key = (arch, B, kv_quant)
    if key in _REF:
        return _REF[key]
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget_config
    from repro.models import model as RM
    from repro.models import serve as RS
    from repro_torch import interop
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced()
    jc = jget_config(arch).reduced()
    L, S = _lengths(arch)
    p = jax.tree_util.tree_map(jnp.asarray,
                               interop.lm_params_seed_numpy(cfg, 0))
    batch = {k: jnp.asarray(v) for k, v in _inputs(arch, B, S, B).items()}
    logits, caches = RS.prefill(p, batch, jc,
                                perf=RM.PerfConfig(kv_quant=kv_quant),
                                max_seq=L)
    step = jax.jit(lambda p, t, c, pos: RS.decode_step(p, t, c, pos, jc))
    out_logits, out_tokens = [], []
    for t in range(N_DEC + 1):
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out_logits.append(np.asarray(logits))
        out_tokens.append(np.asarray(nxt))
        if t < N_DEC:
            logits, caches = step(p, nxt, caches, jnp.int32(S + t))
    _REF[key] = (out_logits, out_tokens)
    return _REF[key]

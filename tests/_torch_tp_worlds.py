"""The tensor-parallel tests' worlds (``tests/test_torch_tensor_parallel.py``
for the dense and encdec families, ``tests/test_torch_family_tensor_
parallel.py`` for the moe, ssm and hybrid ones): CPU ``gloo`` worlds of
spawned processes (``_torch_worlds.run_world``) of a (data, model) mesh
of (1, 2), (2, 2) or (1, 4) ranks, each running a module's reduced
configs with the weights ``interop.lm_params_seed_numpy(cfg, 0)`` on
every side and ``moe_groups=2`` (a multiple of the data ranks; JAX
routes the same groups):

One world a mesh shape runs a module's configs both ways:

- train: two microbatches of 4 sequences through ``make_train_step`` 's
  gradient (``train_step.grads``), the loss and every gradient whole,
  the layout and the rank's tensors' shapes;
- serve: prefill of 16 sequences (the batch over ``data``) and of 4 (a
  tiny batch: the cache sequence over the whole mesh), then 4 greedy
  decode steps, the tokens from the vocabulary-split logits
  (``tensor_parallel.greedy``), each step's collectives, the prefill's
  MoE routing ids, the caches and their placements.

The one-device step runs in the test's own process on the same
functions (``_train_run``, ``_serve_run``) the ranks run, and JAX's
``models.serve`` on the same parameters (``_reference``).  The
row-parallel products sum the ranks' partial sums in another order than
one device adds, so nothing here is bit for bit.  A world runs once for
a module's tests.
"""
import inspect

import numpy as np
import torch

from _torch_worlds import run_world

WORLDS = ((1, 2), (2, 2), (1, 4))
ATOL = 1e-4
INT8_ATOL = 5e-3
REL = 1e-5
BATCHES = (16, 4)
N_DEC = 4
#: GShard dispatch groups of the MoE configs: a multiple of every
#: world's data ranks
MOE_GROUPS = 2
MOE = ("deepseek-v2-lite-16b", "deepseek-v2-236b")
#: (cache length, prompt length); danube's prompt passes its window
LENGTHS = {"h2o-danube-3-4b": (80, 72)}


def world_id(w) -> str:
    return f"{w[0]}x{w[1]}"


def _lengths(arch: str) -> tuple[int, int]:
    return LENGTHS.get(arch, (32, 24))


def _config(name: str):
    """The reduced config of ``name``: an architecture, or
    ``"zamba2-1.2b/6heads"``: zamba2-1.2b with ``expand=3`` and Mamba-2
    heads of 64 channels, 6 heads of its ``d_inner`` 384, at 3 of its 6
    layers (one shared-block segment)."""
    import dataclasses
    from repro_torch.configs import get_config
    arch, _, variant = name.partition("/")
    cfg = get_config(arch).reduced()
    if variant == "6heads":
        cfg = dataclasses.replace(cfg, n_layers=3, ssm=dataclasses.replace(
            cfg.ssm, expand=3, headdim=64))
    return cfg


def _inputs(arch: str, B: int, S: int, seed: int, lead=()) -> dict:
    """The batch's arrays besides labels: tokens [*lead, B, S] and the
    family's embeddings, from ``seed``."""
    cfg = _config(arch)
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
                            perf=PerfConfig(remat="full", accum_steps=2,
                                            moe_groups=2),
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
    step's logits whole, the greedy tokens, the all-gathers, all-reduces
    and all-to-alls of each step, the prefill's MoE routing ids (the
    rank's rows), the caches whole; on a ``DeviceMesh`` also the
    placements.  Runs in a world's ranks and, on the one-device mesh,
    here."""
    import torch
    from torch.distributed.tensor import DTensor
    from repro_torch import interop, tree
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch.costing import CostCounter
    from repro_torch.launch.steps import make_decode_step, make_prefill_step
    from repro_torch.models import moe as MOE
    from repro_torch.models.model import PerfConfig
    from repro_torch.parallel import tensor_parallel as TP
    from repro_torch.parallel.sharding import is_device_mesh

    def whole(x):
        return (x.full_tensor() if isinstance(x, DTensor) else x).clone()
    params = interop.lm_params_from_seed(cfg, 0, "cpu")
    perf = PerfConfig(kv_quant=quant, moe_groups=2)
    B, pos = batch["tokens"].shape
    prefill, _ = make_prefill_step(cfg, ShapeCell("p", L, B, "prefill"),
                                   mesh, perf=perf, dtype=torch.float32,
                                   device="cpu")
    decode, _ = make_decode_step(cfg, ShapeCell("d", L, B, "decode"), mesh,
                                 perf=perf, dtype=torch.float32,
                                 device="cpu")
    r = {"logits": [], "tokens": [], "gathers": [], "reduces": [],
         "all_to_all": [], "routes": []}

    def count(c):
        r["gathers"].append(c.counts["all-gather"])
        r["reduces"].append(c.counts["all-reduce"])
        r["all_to_all"].append(c.counts["all-to-all"])
    route = MOE.route

    def recorded(*args, **kwargs):
        out = route(*args, **kwargs)
        r["routes"].append(out["ids"].clone())
        return out
    MOE.route = recorded
    try:
        with CostCounter() as c:
            logits, caches = prefill(params, batch)
    finally:
        MOE.route = route
    count(c)
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
        count(c)
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

_SCRIPT = _PRELUDE + inspect.getsource(_config) \
    + inspect.getsource(_train_run) + inspect.getsource(_serve_run) + """
for arch in ARGS["train"]:
    RESULT[arch] = _train_run(_config(arch), mesh,
                              batch_of(f"train:{arch}"))

for arch in ARGS["serve"]:
    cfg = _config(arch)
    for B in ARGS["batches"]:
        for quant in (False, True) if (arch, B) in ARGS["int8"] \
                else (False,):
            RESULT[(arch, B, quant)] = _serve_run(
                cfg, mesh, ARGS["lengths"][arch],
                batch_of(f"serve:{arch}:{B}"), quant, ARGS["n_dec"])

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


def tp_world(shape: tuple, tmp_path_factory, train: tuple, serve: tuple,
             int8: tuple = ()) -> list[dict]:
    """The ranks' results of one world on a ``shape`` mesh, run once for
    the calling module's tests: the train runs of ``train`` (keyed by
    config), the serve runs of ``serve`` (keyed by (config, batch,
    int8)), with the int8 cache too for the (config, batch) pairs of
    ``int8``, and the greedy-ties check (``"ties"``)."""
    key = (shape, train, serve, int8)
    if key not in _WORLDS:
        tmp = tmp_path_factory.mktemp(f"world_{world_id(shape)}")
        arrays = {}
        for arch in train:
            arrays.update({f"train:{arch}:{k}": v for k, v in
                           _train_inputs(arch).items()})
        for arch in serve:
            for B in BATCHES:
                arrays.update({f"serve:{arch}:{B}:{k}": v for k, v in
                               _inputs(arch, B, _lengths(arch)[1],
                                       B).items()})
        np.savez(tmp / "inputs.npz", **arrays)
        args = {"world": shape, "train": list(train), "serve": list(serve),
                "inputs": str(tmp / "inputs.npz"), "batches": BATCHES,
                "n_dec": N_DEC, "int8": int8,
                "lengths": {a: _lengths(a)[0] for a in serve}}
        _WORLDS[key] = run_world(tmp, shape[0] * shape[1], _SCRIPT,
                                 args=args, timeout=900, name="world")
    return _WORLDS[key]


_ONE: dict = {}


def one_device(kind: str, arch: str, B: int = 0, quant: bool = False):
    """The one-device step's results of what the worlds run, here."""
    key = (kind, arch, B, quant)
    if key not in _ONE:
        cfg, one = _config(arch), (torch.device("cpu"),)
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


def check_train(ranks, arch) -> None:
    """Each rank's loss within ``REL`` relative and each gradient within
    ``REL`` normwise of the one-device step's."""
    one = one_device("train", arch)
    for rank, res in enumerate(ranks):
        got = res[arch]
        assert abs(got["loss"] - one["loss"]) <= REL * abs(one["loss"]), \
            (rank, got["loss"], one["loss"])
        assert got["grads"].keys() == one["grads"].keys()
        for k, v in one["grads"].items():
            assert _rel(got["grads"][k], v) <= REL, (rank, k)


def check_shares(ranks, archs, m: int) -> None:
    """Where heads (experts, Mamba-2 heads) divide by the ``model`` size
    ``m``, a rank's tensor of every weight the specs split over
    ``model`` is 1/m of it on that axis; a config with fewer KV heads
    than ranks gathers its KV projections (and only them) whole."""
    from repro_torch.launch.steps import params_sds
    from repro_torch.parallel.sharding import param_specs, spec_paths
    for arch in archs:
        cfg = _config(arch)
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


def check_serve(ranks, world, arch) -> None:
    """Each rank's logits within ``ATOL`` of JAX's and of the one-device
    step's, every greedy token JAX's, the caches the one device's and
    placed by the reference's specs; no all-to-all; for a MoE config one
    all-reduce over ``model`` a layer for its FFN and the routing ids of
    the one device."""
    from test_torch_distributed_serve import _expected_placements
    for B in BATCHES:
        want_logits, want_tokens = _reference(arch, B)
        want_pl = _expected_placements(arch, B)
        one = one_device("serve", arch, B)
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
            assert got["all_to_all"] == [0] * (N_DEC + 1)
            if arch in MOE:
                # the embedding, then a layer's attention output and FFN
                # output; in decode also the softmax's max and sums
                n = get_layers(arch)
                assert got["reduces"] == [1 + 2 * n] \
                    + [1 + 4 * n] * N_DEC, got["reduces"]
                _same_routes(got["routes"], one["routes"], world, rank, B)


def _same_routes(got, want, world, rank, B) -> None:
    """A rank's routing ids of each MoE layer of a prefill, [G_local,
    Tg, K], are the one-device step's [G, Tg, K] for the rank's groups:
    its data rank's share of the groups where the batch splits over
    ``data`` (16 sequences), all of them where every rank runs the
    whole batch (a tiny one)."""
    assert len(got) == len(want) > 0
    n_data = world[0] if B >= 16 else 1
    i = rank // world[1] if B >= 16 else 0
    for a, b in zip(got, want):
        per = b.shape[0] // n_data
        assert torch.equal(a, b[i * per:(i + 1) * per]), (rank, B)


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
                                perf=RM.PerfConfig(kv_quant=kv_quant,
                                                   moe_groups=MOE_GROUPS),
                                max_seq=L)
    step = jax.jit(lambda p, t, c, pos: RS.decode_step(
        p, t, c, pos, jc, moe_groups=MOE_GROUPS))
    out_logits, out_tokens = [], []
    for t in range(N_DEC + 1):
        nxt = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        out_logits.append(np.asarray(logits))
        out_tokens.append(np.asarray(nxt))
        if t < N_DEC:
            logits, caches = step(p, nxt, caches, jnp.int32(S + t))
    _REF[key] = (out_logits, out_tokens)
    return _REF[key]

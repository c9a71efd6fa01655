"""The port's ``loss_fn`` and its gradients against the reference's
``jax.value_and_grad(loss_fn, has_aux=True)``, on the CPU at the reduced
configs: the five dense configs here, the moe/MLA, ssm, hybrid and
encdec families in ``test_torch_loss_grads_families.py`` (which imports
:func:`check_loss_and_grads` from this file).

Weights come from ``interop.lm_params_seed_numpy`` to both packages;
tokens, labels and the stub modality embeddings are made with NumPy from
a seed, at B = 2, S = 32.  MoE capacity drops are off (capacity factor
100), as in the family parity tests: a flipped near tie at the capacity
edge would move a token's output a lot.  Both sides run without remat
(``remat="none"``); the port's result does not depend on the policy
(``test_torch_train.py`` holds it bit for bit), and one case here runs
the port under ``remat="full"`` as well.

Tolerance: ``loss``, ``nll`` and ``aux`` within 1e-5 relative (absolute
1e-7 for a zero aux), and every gradient leaf within a normwise relative
gap of 1e-4 (both compute in float32 and sum in other orders: XLA's CPU
against PyTorch's, the port's chunk scan and MoE combine against the
reference's).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jcfg
from repro.models import model as RM
from repro_torch import configs as tcfg
from repro_torch import interop
from repro_torch import tree
from repro_torch.models import model as M

DENSE = ("stablelm-1.6b", "phi3-medium-14b", "codeqwen1.5-7b",
         "h2o-danube-3-4b", "qwen2-vl-72b")
B, S = 2, 32
GRAD_RTOL = 1e-4
LOSS_RTOL = 1e-5


def _cfgs(name):
    out = []
    for pkg in (jcfg, tcfg):
        c = pkg.get_config(name).reduced()
        if c.moe is not None:
            c = dataclasses.replace(
                c, moe=dataclasses.replace(c.moe, capacity_factor=100.0))
        out.append(c)
    return tuple(out)


def _batch(cfg, seed):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32),
              "labels": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        arrays["audio_embeds"] = rng.normal(
            size=(B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.n_prefix_embeds:
        arrays["prefix_embeds"] = rng.normal(
            size=(B, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return arrays


def _rel(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def check_loss_and_grads(name: str, remat: str = "none"):
    jc, tc = _cfgs(name)
    pnp = interop.lm_params_seed_numpy(tc, 3)
    arrays = _batch(tc, 1)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(p, b, jc, perf=RM.PerfConfig(remat="none")),
        has_aux=True))(jax.tree_util.tree_map(jnp.asarray, pnp),
                       {k: jnp.asarray(v) for k, v in arrays.items()})

    params = interop.lm_params_from_reference(pnp, "cpu")
    leaves = [p.requires_grad_(True) for p in tree.leaves(params)]
    loss, met = M.loss_fn(params,
                          {k: torch.from_numpy(v) for k, v in arrays.items()},
                          tc, perf=M.PerfConfig(remat=remat))
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)

    got = {"loss": loss, **met}
    want = {"loss": jl, **jm}
    for key in ("loss", "nll", "aux"):
        assert float(got[key].detach()) == pytest.approx(
            float(want[key]), rel=LOSS_RTOL, abs=1e-7), key
    ref = dict(tree.paths(interop.lm_params_from_reference(
        jax.tree_util.tree_map(np.asarray, jg), "cpu")))
    keys = [k for k, _ in tree.paths(params)]
    assert sorted(keys) == sorted(ref)
    for key, g in zip(keys, grads):
        assert g is not None, key
        gap = _rel(g.numpy(), ref[key].numpy())
        assert gap <= GRAD_RTOL, (name, key, gap)
    # the embedding receives a gradient, as the reference's smoke test
    # asks of its own
    assert float(sum(g.square().sum() for g in grads)) ** 0.5 > 1e-3


@pytest.mark.parametrize("name", DENSE)
def test_loss_and_grads_match_reference(name):
    check_loss_and_grads(name)


def test_loss_and_grads_under_full_remat_match_reference():
    check_loss_and_grads("h2o-danube-3-4b", remat="full")

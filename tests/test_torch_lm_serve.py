"""The port's dense LM serving path (``repro_torch.models``) against the
reference's (``repro.models``) on the CPU, at the reduced configs.

Weights come from the reference's ``init_params`` (carried across by
``interop.lm_params_from_reference``) or from ``interop.lm_params_seed_
numpy``; tokens are made with NumPy from a seed.  Both packages get the
same arrays.

Tolerance: 1e-4 absolute on logits and cached keys and values.  Both
compute in float32 and sum in another order (XLA's CPU against
PyTorch's); the measured gap is about 5e-6 on logits of magnitude 4.
The int8 KV cache rounds ``x / scale`` to an integer, and a 5e-6 gap in x
can put a value on the other side of a .5: its integers are held to 1.
One such flip in a cached key moved the decode logits by 1.2e-3 (codeqwen
reduced, step 18), so int8 decode logits are held to 5e-3 and to the same
greedy token, and the per-token scales (about 0.02), which follow the
decoded keys after such a flip, to 1e-5.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jcfg
from repro.models import model as RM
from repro.models import serve as RS
from repro_torch import configs as tcfg
from repro_torch import interop
from repro_torch.models import model as M
from repro_torch.models import serve as SV
from repro_torch.serve_lm import generate

DENSE = ("h2o-danube-3-4b", "stablelm-1.6b", "codeqwen1.5-7b",
         "phi3-medium-14b", "qwen2-vl-72b")
ATOL = 1e-4
B, S, K = 2, 24, 16          # batch, full length, prompt length


@lru_cache(maxsize=None)
def _ref_params(name: str):
    cfg = jcfg.get_config(name).reduced()
    params = RM.init_params(cfg, jax.random.PRNGKey(0))
    return cfg, params, jax.tree_util.tree_map(np.asarray, params)


def _port_cfg(name: str):
    return tcfg.get_config(name).reduced()


def _batches(cfg, Bn, Sn, seed):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (Bn, Sn))}
    if cfg.n_prefix_embeds:
        arrays["prefix_embeds"] = rng.normal(
            size=(Bn, cfg.n_prefix_embeds, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _close(got: torch.Tensor, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=what)


def _prompt(batch, k):
    out = dict(batch)
    out["tokens"] = batch["tokens"][:, :k]
    return out


def test_configs_match_reference():
    assert tcfg.list_configs() == jcfg.list_configs()
    for name in jcfg.list_configs():
        for f in (lambda c: c, lambda c: c.reduced()):
            a, b = f(tcfg.get_config(name)), f(jcfg.get_config(name))
            assert dataclasses.asdict(a) == dataclasses.asdict(b), name
            assert a.head_dim == b.head_dim
    assert ({k: dataclasses.asdict(v) for k, v in tcfg.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in jcfg.SHAPES.items()})


@pytest.mark.parametrize("name", DENSE)
def test_forward_matches_reference(name):
    cfg, rp, pnp = _ref_params(name)
    params = interop.lm_params_from_reference(pnp, "cpu")
    jb, tb = _batches(cfg, B, S, seed=1)
    want, _ = RM.forward(rp, jb, cfg)
    got, aux = M.forward(params, tb, _port_cfg(name))
    assert got.shape == (B, S, M.vocab_padded(cfg))
    _close(got, want)
    assert float(aux) == 0.0


@pytest.mark.parametrize("name", DENSE)
def test_prefill_and_decode_match_reference(name):
    """Prefill logits and caches, then each decode step's logits and the
    caches after the last step; the port's prefill + decode also equals
    its own full forward at every position (as ``test_archs`` holds the
    reference)."""
    cfg, rp, pnp = _ref_params(name)
    tc = _port_cfg(name)
    params = interop.lm_params_from_reference(pnp, "cpu")
    jb, tb = _batches(cfg, B, S, seed=1)
    full, _ = M.forward(params, tb, tc)
    want, rc = RS.prefill(rp, _prompt(jb, K), cfg, max_seq=S)
    got, caches = SV.prefill(params, _prompt(tb, K), tc, max_seq=S)
    _close(got, want, what="prefill logits")
    _close(got, full[:, K - 1], what="prefill vs forward")
    for key in ("k", "v"):
        _close(caches["layers"][key], rc["layers"][key], what=key)
    np.testing.assert_array_equal(caches["layers"]["slot_pos"].numpy(),
                                  np.asarray(rc["layers"]["slot_pos"]))
    step = jax.jit(lambda p, t, c, pos: RS.decode_step(p, t, c, pos, cfg))
    for t in range(K, S):
        want, rc = step(rp, jb["tokens"][:, t:t + 1], rc, jnp.int32(t))
        got, caches = SV.decode_step(params, tb["tokens"][:, t:t + 1],
                                     caches, t, tc)
        _close(got, want, what=f"decode logits at {t}")
        _close(got, full[:, t], what=f"decode vs forward at {t}")
    for key in ("k", "v"):
        _close(caches["layers"][key], rc["layers"][key], what=key)
    np.testing.assert_array_equal(caches["layers"]["slot_pos"].numpy(),
                                  np.asarray(rc["layers"]["slot_pos"]))


def test_sliding_window_ring_buffer_matches_reference():
    """danube (SWA, window 64 reduced): a 80-token prompt fills the ring
    buffer out of order; decode to 96 wraps it further."""
    name = "h2o-danube-3-4b"
    cfg, rp, pnp = _ref_params(name)
    tc = _port_cfg(name)
    assert tc.sliding_window == 64
    params = interop.lm_params_from_reference(pnp, "cpu")
    Sn, k = 96, 80
    jb, tb = _batches(cfg, 1, Sn, seed=2)
    full, _ = M.forward(params, tb, tc)
    want, rc = RS.prefill(rp, _prompt(jb, k), cfg, max_seq=Sn)
    got, caches = SV.prefill(params, _prompt(tb, k), tc, max_seq=Sn)
    assert caches["layers"]["k"].shape[2] == tc.sliding_window
    _close(got, want)
    _close(got, full[:, k - 1])
    np.testing.assert_array_equal(caches["layers"]["slot_pos"].numpy(),
                                  np.asarray(rc["layers"]["slot_pos"]))
    _close(caches["layers"]["k"], rc["layers"]["k"])
    step = jax.jit(lambda p, t, c, pos: RS.decode_step(p, t, c, pos, cfg))
    for t in range(k, Sn):
        want, rc = step(rp, jb["tokens"][:, t:t + 1], rc, jnp.int32(t))
        got, caches = SV.decode_step(params, tb["tokens"][:, t:t + 1],
                                     caches, t, tc)
        _close(got, want, what=f"decode at {t}")
        _close(got, full[:, t], what=f"decode vs forward at {t}")
    np.testing.assert_array_equal(caches["layers"]["slot_pos"].numpy(),
                                  np.asarray(rc["layers"]["slot_pos"]))


def test_int8_kv_cache_matches_reference():
    name = "codeqwen1.5-7b"
    cfg, rp, pnp = _ref_params(name)
    tc = _port_cfg(name)
    params = interop.lm_params_from_reference(pnp, "cpu")
    jb, tb = _batches(cfg, B, S, seed=3)
    want, rc = RS.prefill(rp, _prompt(jb, K), cfg,
                          perf=RM.PerfConfig(kv_quant=True), max_seq=S)
    got, caches = SV.prefill(params, _prompt(tb, K), tc,
                             perf=M.PerfConfig(kv_quant=True), max_seq=S)
    assert caches["layers"]["k_q"].dtype == torch.int8
    _close(got, want)

    def same_cache():
        for key in ("k_q", "v_q"):
            diff = np.abs(caches["layers"][key].numpy().astype(np.int32)
                          - np.asarray(rc["layers"][key], np.int32))
            assert diff.max() <= 1, key
        for key in ("k_s", "v_s"):
            _close(caches["layers"][key], rc["layers"][key], atol=1e-5)
    same_cache()
    step = jax.jit(lambda p, t, c, pos: RS.decode_step(p, t, c, pos, cfg))
    for t in range(K, S):
        want, rc = step(rp, jb["tokens"][:, t:t + 1], rc, jnp.int32(t))
        got, caches = SV.decode_step(params, tb["tokens"][:, t:t + 1],
                                     caches, t, tc)
        _close(got, want, atol=5e-3, what=f"decode at {t}")
        np.testing.assert_array_equal(got.argmax(-1).numpy(),
                                      np.asarray(jnp.argmax(want, -1)))
    same_cache()


@pytest.mark.parametrize("name", ("h2o-danube-3-4b", "stablelm-1.6b"))
def test_lm_params_from_seed_give_both_packages_the_same_logits(name):
    tc = _port_cfg(name)
    cfg = jcfg.get_config(name).reduced()
    pnp = interop.lm_params_seed_numpy(tc, seed=7)
    ref_shapes = jax.tree_util.tree_map(
        lambda a: a.shape, RM.init_params(cfg, jax.random.PRNGKey(0)))
    assert jax.tree_util.tree_map(lambda a: a.shape, pnp) == ref_shapes
    jb, tb = _batches(cfg, B, S, seed=4)
    want, _ = RM.forward(jax.tree_util.tree_map(jnp.asarray, pnp), jb, cfg)
    got, _ = M.forward(interop.lm_params_from_seed(tc, 7, "cpu"), tb, tc)
    _close(got, want)


def test_generate_matches_reference_greedy_loop():
    """``serve_lm.generate`` (prefill, then greedy decode) picks the same
    tokens from the same logits as the reference example's loop."""
    name = "h2o-danube-3-4b"
    cfg, rp, pnp = _ref_params(name)
    tc = _port_cfg(name)
    P, G = 70, 8                 # the prompt fills the ring buffer (W 64)
    jb, tb = _batches(cfg, B, P, seed=5)
    out = generate(interop.lm_params_from_reference(pnp, "cpu"),
                   tb["tokens"], tc, G, device="cpu")
    assert out["tokens"].shape == (B, G + 1)
    logits, caches = RS.prefill(rp, jb, cfg, max_seq=P + G)
    step = jax.jit(lambda p, t, c, pos: RS.decode_step(p, t, c, pos, cfg))
    for i in range(G + 1):
        toks = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        _close(out["logits"][i], logits, what=f"step {i}")
        np.testing.assert_array_equal(out["tokens"][:, i].numpy(),
                                      np.asarray(toks[:, 0]))
        if i < G:
            logits, caches = step(rp, toks, caches, jnp.int32(P + i))


def test_generate_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    cfg = _port_cfg("stablelm-1.6b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="cuda"):
        generate(params, torch.zeros((1, 4), dtype=torch.long), cfg, 2)

"""The port's moe/MLA, ssm, hybrid and encdec families against the
reference's, on the CPU at the reduced configs.

Weights come from ``interop.lm_params_seed_numpy`` and go to both
packages (the reference gets the arrays as they are, the port through
``interop.lm_params_from_reference``); tokens and whisper's stub audio
embeddings are made with NumPy from a seed.

Tolerance: 1e-4 absolute on logits and on every cache leaf, as the dense
tests (``test_torch_lm_serve.py``): both compute in float32 and sum in
another order (XLA's CPU against PyTorch's; the port's Hillis-Steele
chunk scan against ``jax.lax.associative_scan``; the MoE combine over k
against XLA's scatter-add), and the logits are of magnitude about 4.
Integer leaves (ring slots, cache lengths) are held equal, and so are
the MoE router's expert ids and keep mask: a flipped near tie would move
a token's output a lot, so the ids are asserted before any value.
"""
import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jcfg
from repro.models import mla as RMLA
from repro.models import model as RM
from repro.models import moe as RMOE
from repro.models import serve as RS
from repro_torch import configs as tcfg
from repro_torch import interop
from repro_torch.models import mla as MLA
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import serve as SV
from repro_torch.serve_lm import generate

FAMILIES = ("deepseek-v2-lite-16b", "deepseek-v2-236b", "falcon-mamba-7b",
            "zamba2-1.2b", "whisper-base")
ATOL = 1e-4
B, S, K = 2, 24, 16          # batch, full length, prompt length


def _cfgs(name, **moe):
    """(reference cfg, port cfg) at the reduced size, with ``moe``
    replacing fields of the MoE config where given."""
    out = []
    for pkg in (jcfg, tcfg):
        c = pkg.get_config(name).reduced()
        if moe:
            c = dataclasses.replace(c, moe=dataclasses.replace(c.moe, **moe))
        out.append(c)
    return tuple(out)


@lru_cache(maxsize=None)
def _weights(name: str):
    """(reference params, port params) from the same seeded arrays."""
    pnp = interop.lm_params_seed_numpy(tcfg.get_config(name).reduced(), 3)
    return (jax.tree_util.tree_map(jnp.asarray, pnp),
            interop.lm_params_from_reference(pnp, "cpu"))


def _batches(cfg, Bn, Sn, seed):
    rng = np.random.default_rng(seed)
    arrays = {"tokens": rng.integers(0, cfg.vocab, (Bn, Sn))}
    if cfg.family == "encdec":
        arrays["audio_embeds"] = rng.normal(
            size=(Bn, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return ({k: jnp.asarray(v) for k, v in arrays.items()},
            {k: torch.from_numpy(v) for k, v in arrays.items()})


def _prompt(batch, k):
    out = dict(batch)
    out["tokens"] = batch["tokens"][:, :k]
    return out


def _close(got: torch.Tensor, want, atol=ATOL, what=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=0,
                               atol=atol, err_msg=what)


def _same_caches(got: dict, want: dict, what: str):
    """Every cache leaf: floats within ATOL, integers equal."""
    assert sorted(got) == sorted(want), what
    for key, g in got.items():
        if isinstance(g, dict):
            _same_caches(g, want[key], f"{what}/{key}")
        elif g.dtype in (torch.int32, torch.int64, torch.int8):
            np.testing.assert_array_equal(g.numpy(), np.asarray(want[key]),
                                          err_msg=f"{what}/{key}")
        else:
            assert tuple(g.shape) == tuple(want[key].shape), (what, key)
            _close(g, want[key], what=f"{what}/{key}")


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_shapes(v) for v in tree]
    return tuple(tree.shape)


@pytest.mark.parametrize("name", FAMILIES)
def test_params_round_trip(name):
    """``lm_params_seed_numpy`` has the reference's pytree shapes; the
    port's ``init_params`` and ``lm_params_from_reference`` of the
    reference's own ``init_params`` have the same layout (stacks as lists
    of per-layer dicts, ``shared_block`` and ``enc_norm`` unstacked)."""
    jc, tc = _cfgs(name)
    ref = RM.init_params(jc, jax.random.PRNGKey(0))
    ref_np = jax.tree_util.tree_map(np.asarray, ref)
    pnp = interop.lm_params_seed_numpy(tc, 0)
    assert jax.tree_util.tree_map(lambda a: a.shape, pnp) == \
        jax.tree_util.tree_map(lambda a: a.shape, ref_np)
    carried = interop.lm_params_from_reference(ref_np, "cpu")
    own = M.init_params(tc, torch.Generator().manual_seed(0))
    assert _shapes(carried) == _shapes(own)
    for key in interop.STACKED_KEYS:
        if key in ref_np:
            for i, layer in enumerate(carried[key]):
                for path, leaf in _flat(layer):
                    np.testing.assert_array_equal(
                        leaf.numpy(), _at(ref_np[key], path)[i],
                        err_msg=f"{key}[{i}]/{path}")
    if "shared_block" in ref_np:
        for path, leaf in _flat(carried["shared_block"]):
            np.testing.assert_array_equal(
                leaf.numpy(), _at(ref_np["shared_block"], path))


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _at(tree, path: str):
    for k in path.split("/"):
        tree = tree[k]
    return tree


@pytest.mark.parametrize("name", FAMILIES)
def test_forward_matches_reference(name):
    jc, tc = _cfgs(name)
    rp, tp = _weights(name)
    jb, tb = _batches(tc, B, S, seed=1)
    want, want_aux = jax.jit(lambda p, b: RM.forward(p, b, jc))(rp, jb)
    got, aux = M.forward(tp, tb, tc)
    assert got.shape == (B, S, M.vocab_padded(tc))
    _close(got, want)
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-5,
                               atol=1e-7)
    assert (float(aux) > 0) == (tc.family == "moe")


@pytest.mark.parametrize("name", FAMILIES)
def test_prefill_and_decode_match_reference(name):
    """Prefill logits and every cache leaf, each decode step's logits,
    and every cache leaf after the last step.  The MoE capacity is raised
    past any drop (as ``test_archs`` does) so that the port's prefill +
    decode also equals its own ``forward`` at every position."""
    jc, tc = _cfgs(name, capacity_factor=100.0) \
        if "deepseek" in name else _cfgs(name)
    rp, tp = _weights(name)
    jb, tb = _batches(tc, B, S, seed=2)
    full, _ = M.forward(tp, tb, tc)
    want, rc = RS.prefill(rp, _prompt(jb, K), jc, max_seq=S)
    got, caches = SV.prefill(tp, _prompt(tb, K), tc, max_seq=S)
    _close(got, want, what="prefill logits")
    _close(got, full[:, K - 1], what="prefill vs forward")
    _same_caches(caches, rc, "prefill")
    step = jax.jit(lambda p, t, c, pos: RS.decode_step(p, t, c, pos, jc))
    for t in range(K, S):
        want, rc = step(rp, jb["tokens"][:, t:t + 1], rc, jnp.int32(t))
        got, caches = SV.decode_step(tp, tb["tokens"][:, t:t + 1], caches,
                                     t, tc)
        _close(got, want, what=f"decode logits at {t}")
        _close(got, full[:, t], what=f"decode vs forward at {t}")
    _same_caches(caches, rc, "decode")


@pytest.mark.parametrize("name", FAMILIES)
def test_generate_matches_reference_greedy_loop(name):
    """``serve_lm.generate`` picks the reference loop's tokens from the
    reference loop's logits (whisper with its audio through
    ``batch_extra``)."""
    jc, tc = _cfgs(name)
    rp, tp = _weights(name)
    P, G = 12, 4
    jb, tb = _batches(tc, B, P, seed=5)
    extra = {k: v for k, v in tb.items() if k != "tokens"}
    out = generate(tp, tb["tokens"], tc, G, device="cpu", batch_extra=extra)
    assert out["tokens"].shape == (B, G + 1)
    logits, caches = RS.prefill(rp, jb, jc, max_seq=P + G)
    step = jax.jit(lambda p, t, c, pos: RS.decode_step(p, t, c, pos, jc))
    for i in range(G + 1):
        toks = jnp.argmax(logits, -1)[:, None].astype(jnp.int32)
        _close(out["logits"][i], logits, what=f"step {i}")
        np.testing.assert_array_equal(out["tokens"][:, i].numpy(),
                                      np.asarray(toks[:, 0]))
        if i < G:
            logits, caches = step(rp, toks, caches, jnp.int32(P + i))


# ---------------------------------------------------------------------------
# MoE: routing, drops and the aux loss
# ---------------------------------------------------------------------------

def _reference_routing(monkeypatch, lp, x, jc, groups):
    """The reference's ``moe_ffn`` run eagerly, with the ids its
    ``jax.lax.top_k`` returned; and its keep mask in token-major order,
    formed from those ids as its dispatch forms it."""
    seen = []
    top_k = jax.lax.top_k

    def recording(a, k):
        out = top_k(a, k)
        seen.append(np.asarray(out[1]))
        return out
    monkeypatch.setattr(jax.lax, "top_k", recording)
    y, aux = RMOE.moe_ffn(lp, jnp.asarray(x), jc, groups=groups)
    monkeypatch.undo()
    (ids,) = seen
    G, Tg, Kk = ids.shape
    cap = RMOE._capacity(Tg, jc)
    flat = ids.reshape(G, Tg * Kk)
    order = np.argsort(flat, axis=1, kind="stable")
    srt = np.take_along_axis(flat, order, 1)
    run_start = np.stack([np.searchsorted(s, s, side="left") for s in srt])
    keep = np.zeros_like(flat, bool)
    np.put_along_axis(keep, order, np.arange(Tg * Kk)[None] - run_start
                      < cap, 1)
    return np.asarray(y), float(aux), ids, keep


@pytest.mark.parametrize("groups", (1, 2))
@pytest.mark.parametrize("capacity", (1.25, 0.5))
@pytest.mark.parametrize("name", ("deepseek-v2-lite-16b", "deepseek-v2-236b"))
def test_moe_routing_drops_and_aux_match_reference(monkeypatch, name,
                                                   capacity, groups):
    """Routed ids, the keep mask (which (token, k) entries the capacity
    drops) and the drop count equal the reference's; then the layer's
    output and aux loss, with ``groups`` 1 and 2 (GShard group-local
    capacity) and a tight capacity that drops many entries."""
    jc, tc = _cfgs(name, capacity_factor=capacity)
    _, tp = _weights(name)
    rp_np = interop.lm_params_seed_numpy(tc, 3)["layers"]["moe"]
    lp_ref = jax.tree_util.tree_map(lambda a: jnp.asarray(a[0]), rp_np)
    lp = tp["layers"][0]["moe"]
    x = np.random.default_rng(7).normal(
        size=(4, 16, tc.d_model)).astype(np.float32)
    want, want_aux, ids, keep = _reference_routing(monkeypatch, lp_ref, x,
                                                   jc, groups)
    r = MOE.route(lp, torch.from_numpy(x), tc, groups)
    np.testing.assert_array_equal(r["ids"].numpy(), ids)
    got_keep = r["keep"].numpy()
    np.testing.assert_array_equal(got_keep, keep)
    dropped = int((~got_keep).sum())
    assert dropped == int((~keep).sum())
    if capacity < 1:
        assert dropped > 0
    y, aux = MOE.moe_ffn(lp, torch.from_numpy(x), tc, groups=groups)
    _close(y, want, what="moe output")
    np.testing.assert_allclose(float(aux), want_aux, rtol=1e-5, atol=1e-7)


def test_moe_aux_loss_balances():
    """The twin of ``test_archs.py::test_moe_aux_loss_balances``: the aux
    loss is about 1.0 x weight per MoE layer for a router at init."""
    _, tc = _cfgs("deepseek-v2-lite-16b")
    _, tp = _weights("deepseek-v2-lite-16b")
    _, tb = _batches(tc, 2, 64, seed=4)
    _, aux = M.forward(tp, tb, tc)
    expect = tc.moe.aux_weight * (tc.n_layers - tc.moe.first_dense)
    assert 0.5 * expect < float(aux) < 2.0 * expect


# ---------------------------------------------------------------------------
# SSM and MLA: the port against itself
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ("falcon-mamba-7b", "zamba2-1.2b"))
def test_ssm_chunk_invariance(name):
    """The twin of ``test_archs.py::test_ssm_chunk_invariance``: the
    chunked scan's result does not depend on the chunk size (chunks of
    4, 8 and the whole 32), to the reference test's 2e-4."""
    _, tc = _cfgs(name)
    _, tp = _weights(name)
    _, tb = _batches(tc, 2, 32, seed=6)
    outs = []
    for chunk in (4, 8, 32):
        c2 = dataclasses.replace(tc, ssm=dataclasses.replace(tc.ssm,
                                                             chunk=chunk))
        outs.append(M.forward(tp, tb, c2)[0].numpy())
    np.testing.assert_allclose(outs[0], outs[1], rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(outs[0], outs[2], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", ("deepseek-v2-lite-16b", "deepseek-v2-236b"))
def test_chunked_mla_matches_unchunked_and_reference(name):
    """``attn_chunk`` 8 on 32 positions (four chunks of the online
    softmax) against the materialised softmax, both within 1e-5 on the
    attention output; and the chunked path against the reference's."""
    jc, tc = _cfgs(name)
    rp, tp = _weights(name)
    lp = tp["dense_layers"][0]["attn"]
    lp_ref = jax.tree_util.tree_map(lambda a: a[0], rp["dense_layers"])["attn"]
    x = np.random.default_rng(8).normal(
        size=(2, 32, tc.d_model)).astype(np.float32)
    pos = M.positions_for(2, 32, "cpu")
    with torch.no_grad():
        full = MLA.mla_train(lp, torch.from_numpy(x), pos, tc)
        chunked = MLA.mla_train(lp, torch.from_numpy(x), pos, tc, chunk=8)
    _close(chunked, full.numpy(), atol=1e-5, what="chunked vs unchunked")
    want = RMLA.mla_train(lp_ref, jnp.asarray(x),
                          jnp.asarray(pos.numpy()), jc, chunk=8)
    _close(chunked, want, what="chunked vs the reference's")


@pytest.mark.parametrize("name", ("deepseek-v2-lite-16b", "deepseek-v2-236b"))
def test_absorbed_mla_decode_matches_expanded_form(name):
    """Absorbed decode on the compressed cache (w_uk folded into the
    query, w_uv into the output) against the expanded attention's last
    position over the same tokens, at each of 8 steps, within 1e-5."""
    _, tc = _cfgs(name)
    _, tp = _weights(name)
    lp = tp["layers"][0]["attn"]
    n, k = 24, 16
    x = torch.from_numpy(np.random.default_rng(9).normal(
        size=(2, n, tc.d_model)).astype(np.float32))
    pos = M.positions_for(2, n, "cpu")
    cache = MLA.init_cache(tc, 2, n)
    with torch.no_grad():
        expanded = MLA.mla_train(lp, x, pos, tc)
        MLA.mla_prefill(lp, x[:, :k], pos[:, :k], tc, cache=cache)
        for t in range(k, n):
            out, cache = MLA.mla_decode(lp, x[:, t:t + 1], cache, t, tc)
            _close(out[:, 0], expanded[:, t].numpy(), atol=1e-5,
                   what=f"step {t}")
    assert int(cache["len"]) == n

"""Parameter counts and roofline terms of the port against the reference.

``repro_torch.launch.steps.params_sds`` builds each config's parameter
tree on ``"meta"`` (shapes, no memory) where the reference runs
``jax.eval_shape``; the counts must be the reference's integers for all
ten configs, ``deepseek-v2-236b`` and ``qwen2-vl-72b`` included.  The
roofline arithmetic and the HLO collective parser are the reference's
(``tests/test_roofline.py``), against the port's own H100 constants.
"""
import functools

import jax.numpy as jnp
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import list_configs
from repro.launch import roofline as JRF
from repro.launch.steps import params_sds as jparams_sds
from repro_torch.configs import SHAPES, cell_is_runnable, get_config
from repro_torch.launch import roofline as RF
from repro_torch.launch.steps import params_sds

ALL = list_configs()


@functools.lru_cache(maxsize=None)
def _sds(name):
    return params_sds(get_config(name), torch.bfloat16)


@functools.lru_cache(maxsize=None)
def _jsds(name):
    return jparams_sds(jget_config(name), jnp.bfloat16)


def _leaves(tree):
    return [leaf for _, leaf in RF._leaves_with_keys(tree)]


@pytest.mark.parametrize("name", ALL)
def test_param_counts_match_reference(name):
    """Total and active counts equal the reference's ``eval_shape``
    counts, every leaf on ``"meta"`` with the reference's dtype."""
    tree = _sds(name)
    leaves = _leaves(tree)
    assert leaves and all(l.device.type == "meta" for l in leaves)
    assert RF.count_params(tree) == JRF.count_params(_jsds(name))
    assert RF.count_active_params(get_config(name), tree) \
        == JRF.count_active_params(jget_config(name), _jsds(name))
    # the reference stacks layers into one leaf, the port keeps a list:
    # compare the parameters of each dtype
    import jax

    def by_dtype(pairs):
        out = {}
        for dtype, n in pairs:
            out[dtype] = out.get(dtype, 0) + n
        return out
    assert by_dtype((str(l.dtype).replace("torch.", ""), l.numel())
                    for l in leaves) \
        == by_dtype((str(l.dtype), int(RF._prod(l.shape)))
                    for l in jax.tree_util.tree_leaves(_jsds(name)))


@pytest.mark.parametrize("name", ALL)
def test_param_counts(name):
    """The reference's ``test_launch_costs.py`` bands, on the port."""
    cfg = get_config(name)
    total = RF.count_params(_sds(name))
    active = RF.count_active_params(cfg, _sds(name))
    assert total > 0
    assert 0 < active <= total
    if cfg.moe is None:
        assert active == total
    else:
        assert active < total
    tag = name.rsplit("-", 1)[-1]
    if tag.endswith("b") and tag[:-1].replace(".", "").isdigit():
        claimed = float(tag[:-1]) * 1e9
        assert 0.4 * claimed < total < 2.5 * claimed, (name, total)


@pytest.mark.parametrize("name", ALL)
def test_reference_flops_per_shape(name):
    """``model_flops_per_device`` for every runnable shape cell, equal to
    the reference's."""
    from repro.configs import SHAPES as JSHAPES
    cfg = get_config(name)
    for key, cell in SHAPES.items():
        ok, _reason = cell_is_runnable(cfg, cell)
        if not ok:
            continue
        flops = RF.model_flops_per_device(cfg, cell, _sds(name), n_chips=16)
        assert flops > 0
        assert flops == JRF.model_flops_per_device(
            jget_config(name), JSHAPES[key], _jsds(name), n_chips=16)


def test_init_params_on_a_device_keeps_the_draws():
    """``device=`` defaults to the generator's device: the same seed gives
    the same weights with and without it, and ``"meta"`` the same shapes
    and dtypes."""
    import dataclasses
    from repro_torch.models import model as M
    cfg = dataclasses.replace(get_config("deepseek-v2-lite-16b"),
                              n_layers=2, d_model=64, vocab=300)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_routed=4, d_expert=16))
    a = M.init_params(cfg, torch.Generator().manual_seed(3))
    b = M.init_params(cfg, torch.Generator().manual_seed(3), device="cpu")
    m = M.init_params(cfg, torch.Generator().manual_seed(3), device="meta")
    for x, y, z in zip(_leaves(a), _leaves(b), _leaves(m)):
        assert torch.equal(x, y)
        assert (z.device.type, z.shape, z.dtype) == ("meta", x.shape,
                                                    x.dtype)


# ---------------------------------------------------------------------------
# roofline arithmetic and the HLO collective parser (test_roofline.py)
# ---------------------------------------------------------------------------

HLO = """
ENTRY %main {
  %p0 = bf16[16,512]{1,0} parameter(0)
  %ag = bf16[256,512]{1,0} all-gather(%p0), replica_groups=[16,16]<=[256], dimensions={0}
  %ar = f32[1024]{0} all-reduce(%x), replica_groups={{0,1,2,3}}, to_apply=%sum
  %rs = f32[64,32]{1,0} reduce-scatter(%y), replica_groups=[8,32]<=[256], dimensions={0}
  %cp = bf16[128]{0} collective-permute(%z), source_target_pairs={{0,1}}
  %tup = (f32[256]{0}, f32[256]{0}) all-reduce(%a, %b), replica_groups=[16,16]<=[256]
  %dot = bf16[16,16]{1,0} dot(%p0, %p0)
}
"""


def test_parse_collectives_matches_reference():
    assert RF.parse_collectives(HLO) == JRF.parse_collectives(HLO)
    for text in ("%d = bf16[8,8]{1,0} dot(%a, %b)\n", ""):
        assert RF.parse_collectives(text) == JRF.parse_collectives(text)


def test_parse_collectives_counts_and_wire_formulas():
    out = RF.parse_collectives(HLO)
    assert out["counts"] == {"all-reduce": 2, "all-gather": 1,
                             "reduce-scatter": 1, "all-to-all": 0,
                             "collective-permute": 1}
    ag = 256 * 512 * 2 * 15 / 16
    ar = 2 * 1024 * 4 * 3 / 4 + 2 * (2 * 256 * 4) * 15 / 16
    rs = 64 * 32 * 4 * 31
    assert out["all-gather"] == pytest.approx(ag)
    assert out["all-reduce"] == pytest.approx(ar)
    assert out["reduce-scatter"] == pytest.approx(rs)
    assert out["collective-permute"] == pytest.approx(128 * 2)
    assert out["total_wire_bytes"] == pytest.approx(ag + ar + rs + 128 * 2)


def test_roofline_terms_and_dominance():
    """The reference's arithmetic at the port's constants."""
    terms = RF.roofline(
        {"flops": RF.PEAK_FLOPS, "bytes accessed": RF.HBM_BW * 2},
        {"total_wire_bytes": RF.ICI_BW * 0.5},
        model_flops=RF.PEAK_FLOPS * 0.75)
    assert terms.compute_s == pytest.approx(1.0)
    assert terms.memory_s == pytest.approx(2.0)
    assert terms.collective_s == pytest.approx(0.5)
    assert terms.dominant == "memory"
    assert terms.bound_s == pytest.approx(2.0)
    assert terms.useful_ratio == pytest.approx(0.75)
    assert terms.roofline_fraction == pytest.approx(0.5)
    cost = {"flops": 3.0e12, "bytes accessed": 5.0e10}
    coll = {"total_wire_bytes": 2.0e9}
    got = RF.roofline(cost, coll, 1.5e12)
    want = JRF.roofline(cost, coll, 1.5e12)
    assert (got.flops, got.bytes_accessed, got.wire_bytes,
            got.model_flops, got.useful_ratio) \
        == (want.flops, want.bytes_accessed, want.wire_bytes,
            want.model_flops, want.useful_ratio)
    assert got.compute_s == cost["flops"] / RF.PEAK_FLOPS


def test_constants_are_the_h100s():
    """No TPU figure stays in the port: the H100 SXM's data-sheet
    peaks."""
    assert (RF.PEAK_FLOPS, RF.HBM_BW, RF.ICI_BW) == (989e12, 3.35e12, 450e9)
    import inspect
    src = inspect.getsource(RF)
    for word in ("TPU", "v5e", "197", "819"):
        assert word not in src, word


def test_model_flops_train_vs_decode():
    cfg = get_config("stablelm-1.6b")
    psds = _sds("stablelm-1.6b")
    n = RF.count_params(psds)
    assert 1.5e9 < n < 2.1e9
    train = RF.model_flops_per_device(cfg, SHAPES["train_4k"], psds, 256)
    dec = RF.model_flops_per_device(cfg, SHAPES["decode_32k"], psds, 256)
    assert train == pytest.approx(6 * n * 256 * 4096 / 256)
    assert dec == pytest.approx(2 * n * 128 / 256)


def test_moe_active_params_discounted():
    cfg = get_config("deepseek-v2-lite-16b")
    psds = _sds("deepseek-v2-lite-16b")
    assert RF.count_active_params(cfg, psds) \
        < 0.35 * RF.count_params(psds)

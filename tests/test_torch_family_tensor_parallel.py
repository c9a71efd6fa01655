"""Tensor-parallel compute over ``model`` (``parallel/tensor_parallel.py``)
for the moe/MLA, ssm and hybrid families on CPU ``gloo`` worlds
(``_torch_tp_worlds``, as ``tests/test_torch_tensor_parallel.py`` holds
the dense and encdec families).

Each rank runs its ``E / m`` experts (every rank routes its data rank's
tokens with the replicated router), MLA on its heads, a Mamba layer on
its ``d_inner`` channels, as the reference's specs split them.  The
worlds run the reduced configs of deepseek-v2-lite-16b (MLA, 8 experts
over ``model``), deepseek-v2-236b (MLA with q-LoRA), falcon-mamba-7b
(Mamba-1) and zamba2-1.2b (Mamba-2 and the shared attention block),
``moe_groups=2``:

- train: the loss within 1e-5 relative and each gradient within 1e-5
  normwise of the one-device step's; and zamba2-1.2b with 6 Mamba-2
  heads, which 4 ranks cannot split;
- serve: logits within ``ATOL`` of JAX's ``models.serve`` and of the
  one-device step's, every greedy token JAX's, the caches (MLA's
  ``c_kv``/``k_rope``, the Mamba ``conv``/``h``) placed by the
  reference's specs; each rank's MoE routing ids of a prefill the one
  device's for its rows, bit for bit; no all-to-all, and one all-reduce
  over ``model`` a layer for a MoE config's FFN (its routed and shared
  experts together);
- layout: a rank holds 1/m of every split weight, the experts too.
"""
import pytest

from _torch_tp_worlds import (REL, WORLDS, _rel, check_serve, check_shares,
                              check_train, one_device, tp_world, world_id)

ARCHS = ("deepseek-v2-lite-16b", "deepseek-v2-236b", "falcon-mamba-7b",
         "zamba2-1.2b")
#: trained in the train worlds only: zamba2-1.2b reduced with
#: ``expand=3`` and Mamba-2 heads of 64 channels, so 6 heads of its
#: ``d_inner`` 384, which 4 ``model`` ranks cannot split (its Mamba
#: weights are gathered whole there; 2 ranks split them), at 3 layers
UNALIGNED = "zamba2-1.2b/6heads"


def _world(world: tuple, tmp_path_factory) -> list[dict]:
    return tp_world(world, tmp_path_factory, train=ARCHS + (UNALIGNED,),
                    serve=ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS, ids=world_id)
def test_train_gradients_match_one_device(world, arch, tmp_path_factory):
    check_train(_world(world, tmp_path_factory), arch)


@pytest.mark.parametrize("world", WORLDS, ids=world_id)
def test_unaligned_mamba2_heads_train_from_weights_gathered_whole(
        world, tmp_path_factory):
    """Where the ``model`` ranks cannot split Mamba-2's heads (6 heads
    over 4 ranks: 2, 2, 2 and 0 of them), the Mamba weights split over
    ``d_inner`` are gathered whole and each rank slices its heads'
    channels; the gradients still match one device."""
    ranks = _world(world, tmp_path_factory)
    one = one_device("train", UNALIGNED)
    for rank, res in enumerate(ranks):
        got = res[UNALIGNED]
        assert abs(got["loss"] - one["loss"]) <= REL * abs(one["loss"])
        for k, v in one["grads"].items():
            assert _rel(got["grads"][k], v) <= REL, (rank, k)
        whole = {k for k, v in got["layout"].items() if v == "whole"}
        if world[1] == 4:
            assert whole == {k for k in got["layout"] if "/ssm/" in k
                             and k.split("/")[-1] in (
                                 "in_proj_x", "in_proj_z", "conv_w",
                                 "conv_b", "norm_w", "out_proj")}, whole
        else:
            assert not whole


@pytest.mark.parametrize("world", WORLDS, ids=world_id)
def test_a_rank_holds_its_share_of_each_split_weight(world,
                                                     tmp_path_factory):
    """A rank's tensor of every weight the specs split over ``model``,
    the experts included, is 1/m of it on that axis, and none is
    gathered whole."""
    check_shares(_world(world, tmp_path_factory), ARCHS, world[1])


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS, ids=world_id)
def test_prefill_decode_match_reference(world, arch, tmp_path_factory):
    check_serve(_world(world, tmp_path_factory), world, arch)

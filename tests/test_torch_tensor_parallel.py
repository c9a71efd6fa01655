"""Tensor-parallel compute over ``model`` (``parallel/tensor_parallel.py``)
for the dense and encdec families on CPU ``gloo`` worlds
(``_torch_tp_worlds``; the moe, ssm and hybrid families are
``tests/test_torch_family_tensor_parallel.py``'s).

The dense and encdec families split their heads, ``d_ff`` and
vocabulary over the mesh axis ``model``, as the reference's specs and
activation hooks make XLA split them.  The worlds run the reduced
configs of stablelm-1.6b, h2o-danube-3-4b (1 KV head, fewer than the
``model`` ranks, and a 64-slot window that the prompt passes),
qwen2-vl-72b (M-RoPE, prefix embeddings, 1 KV head, QKV biases) and
whisper-base:

- train: the loss within 1e-5 relative and each gradient's
  ``full_tensor()`` within 1e-5 normwise of the one-device step's;
- serve: logits within ``ATOL`` of JAX's ``models.serve`` on the same
  parameters and of the one-device step's, every greedy token JAX's,
  the caches placed by the reference's specs; danube's int8 cache
  within ``INT8_ATOL`` with the same tokens (``tests/test_torch_lm_
  serve.py`` gives the bound's cause);
- layout: a rank holds 1/m of every split weight where heads divide,
  only the KV projections of a config with fewer KV heads than ranks are
  gathered whole over ``model``, and a stablelm step on a (1, m) mesh
  issues no all-gather but those of the decode activations.
"""
import numpy as np
import pytest
import torch

from _torch_tp_worlds import (INT8_ATOL, WORLDS, _reference, check_serve,
                              check_shares, check_train, one_device,
                              tp_world, world_id)

ARCHS = ("stablelm-1.6b", "h2o-danube-3-4b", "qwen2-vl-72b", "whisper-base")
#: the int8 cache's runs: danube (GQA, a window) at the split batch
INT8 = (("h2o-danube-3-4b", 16),)


def _world(world: tuple, tmp_path_factory) -> list[dict]:
    return tp_world(world, tmp_path_factory, train=ARCHS, serve=ARCHS,
                    int8=INT8)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS, ids=world_id)
def test_train_gradients_match_one_device(world, arch, tmp_path_factory):
    check_train(_world(world, tmp_path_factory), arch)


@pytest.mark.parametrize("world", WORLDS, ids=world_id)
def test_a_rank_holds_its_share_of_each_split_weight(world,
                                                     tmp_path_factory):
    """Where heads divide by the ``model`` size, a rank's tensor of every
    weight the specs split over ``model`` is 1/m of it on that axis; a
    config with fewer KV heads than ranks gathers its KV projections
    (and only them) whole; on a (1, m) mesh, where the data axis gathers
    nothing, a stablelm gradient issues no all-gather at all."""
    ranks = _world(world, tmp_path_factory)
    check_shares(ranks, ARCHS, world[1])
    if world[0] == 1:
        for res in ranks:
            assert res["stablelm-1.6b"]["all_gathers"] == 0


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("world", WORLDS, ids=world_id)
def test_prefill_decode_match_reference(world, arch, tmp_path_factory):
    check_serve(_world(world, tmp_path_factory), world, arch)


@pytest.mark.parametrize("arch, B", INT8)
@pytest.mark.parametrize("world", WORLDS, ids=world_id)
def test_int8_cache_decode_matches_one_device(world, arch, B,
                                              tmp_path_factory):
    ranks = _world(world, tmp_path_factory)
    one = one_device("serve", arch, B, quant=True)
    _, want_tokens = _reference(arch, B, kv_quant=True)
    for rank, res in enumerate(ranks):
        got = res[(arch, B, True)]
        for a, b in zip(got["logits"], one["logits"]):
            np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0,
                                       atol=INT8_ATOL)
        for a, b, w in zip(got["tokens"], one["tokens"], want_tokens):
            assert torch.equal(a, b) and np.array_equal(a.numpy(), w)
        assert got["caches"]["layers/k_q"].dtype == torch.int8


@pytest.mark.parametrize("world", WORLDS, ids=world_id)
def test_greedy_ties_go_to_the_lowest_index(world, tmp_path_factory):
    for res in _world(world, tmp_path_factory):
        assert torch.equal(res["ties"], torch.full((16, 1), 3,
                                                   dtype=torch.int32))

"""Port parity, tensor-parallel CIM serving, the remaining variants of
tests/test_torch_tp_serve.py (its module docstring holds the contract and
the tolerances): gemma2-9b at M = 2 with IR drop (47-column tiles), smoke
deepseek-moe-16b (1 layer, 4 experts, top-2, M = 2: the experts placed
expert-parallel on the mesh) and smoke rwkv6-7b (M = 2). The tests of
tests/test_torch_tp_serve.py run here on this module's `served` fixture,
so that each file stays under a minute; the MoE variant's expert chips
get tests of their own."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import assert_chip_match, to_numpy, to_torch
from test_torch_tp_serve import (  # noqa: F401
    _serve, counts_tol, one_thread, test_chip_meter_energy_equals_reference,
    test_cpu_serve_launches_no_kernel, test_greedy_tokens_equal,
    test_logits_allclose, test_loop_matches_reference_loop_under_counts_rule,
    test_loop_combines_shards_in_order, test_partitions_match,
    test_shard_chips_match)

from repro.models import moe as jmoe
from repro_torch.launch.mesh import Mesh
from repro_torch.models import moe as tmoe
from repro_torch.models import nn as tnn


@pytest.fixture(scope="module",
                params=["tp2-irdrop", "deepseek-tp2", "rwkv6-tp2"])
def served(request):
    return _serve(request.param)


@pytest.fixture(scope="module")
def served_moe():
    return _serve("deepseek-tp2")


@pytest.mark.parametrize("name", tnn.PACKED_EXPERT_KEYS)
def test_expert_chips_match(served_moe, name):
    """Every layer's every expert chip against the reference's."""
    ref = served_moe["ref"]["layers"][name + "_cim"]
    for li, experts in enumerate(served_moe["tparams"]["layers"][name +
                                                                 "_cim"]):
        assert len(experts) == served_moe["tcfg"].n_experts
        for e, pcl in enumerate(experts):
            pj = jax.tree_util.tree_map(lambda a: np.asarray(a)[li, e], ref)
            assert_chip_match(pcl, pj, f"{name} layer {li} expert {e}")


@pytest.mark.parametrize("name", tnn.PACKED_EXPERT_KEYS)
def test_expert_matmul_matches_reference_loop(served_moe, name):
    """Layer 0's expert-parallel chips through `_expert_matmul` against
    the reference's expert loop on its chips, each expert's output within
    one ADC count per .5-boundary tile (its seed follows its global id in
    both)."""
    cfg, jc = served_moe["tcfg"], served_moe["jc"]
    p0 = {k: v[0] for k, v in served_moe["tparams"]["layers"].items()}
    ref = served_moe["ref"]["layers"]
    j0 = {name: np.asarray(ref[name])[0],
          name + "_cim": jax.tree_util.tree_map(lambda a: a[0],
                                                ref[name + "_cim"])}
    x = np.random.default_rng(3).standard_normal(
        (cfg.n_experts, 4, p0[name].shape[1])).astype(np.float32)
    want = np.asarray(jmoe._expert_matmul(j0, name, jnp.asarray(x), jc,
                                          seed=11))
    got = to_numpy(tmoe._expert_matmul(p0, name, to_torch(x), cfg, seed=11))
    ccfg = tnn.arch_cim_config(cfg)
    tol = np.stack([counts_tol(c, x[e], ccfg)
                    for e, c in enumerate(p0[name + "_cim"])])
    assert got.shape == want.shape
    assert np.all(np.abs(got - want) <= tol + 1e-5 * np.abs(want).max())


def test_placement_puts_each_shard_and_expert_on_its_device(served_moe):
    """Placement onto a mesh of two distinct devices (the CPU and the
    meta device): shard s of a layer's chips on 'model' device s, expert
    e on the device of shard e // (E / 2); the tables move with them."""
    mesh = Mesh([["cpu", "meta"]])
    lay = served_moe["tparams"]["layers"]
    spls = tnn.place_packed_stack(lay["wq_cim"], mesh, 2)
    for spl in spls:
        assert [c.packed.gd_tiles.device.type for c in spl.shards] == \
            ["cpu", "meta"]
        assert spl.shards[1].packed.row_index.device.type == "meta"
        assert spl.shards[1].layer.in_alpha.device.type == "meta"
    experts = tnn.place_packed_stack(lay["ew_g_cim"], mesh, 2)
    n = served_moe["tcfg"].n_experts
    for layer in experts:
        assert [c.packed.gd_tiles.device.type for c in layer] == \
            ["cpu"] * (n // 2) + ["meta"] * (n // 2)
    # already on its device: the chip itself, nothing copied
    assert tnn._place_chip(lay["wq_cim"][0].shards[0],
                           torch.device("cpu")) is lay["wq_cim"][0].shards[0]

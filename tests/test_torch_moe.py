"""Port parity, mixture-of-experts serving (`repro_torch/models/moe.py`, the
MoE half of `models/transformer.py`, the expert-chip deploy of
`models/nn.py`): the JAX reference and the port on the CPU, from the same
numpy inputs and params.

Float path (cim_mode "off", f32): `moe_ffn` at capacity factors 1.0 (routes
dropped) and 16 (none dropped) and dropless, at MOE_ATOL; the whole model
teacher-forced (`lm_forward`) for deepseek-moe-16b and llama4's 1:1
dense/MoE interleave, at LOGIT_ATOL. MOE_ATOL = 1e-5: the FFN's outputs
are O(1) after O(100) f32 roundings taken in another order by the two
packages (2^-24 * 100 ~ 6e-6).

Routing near-ties: where a token's k-th and (k+1)-th router logits lie
within the f32 error band of the router's dot (TIE_BAND: 4 (d + 2) 2^-24
|x| @ |w|, both packages' rounding and their inputs' drift), the two
packages may pick different experts. Such tokens are computed
(`near_ties`) and left out of the comparison, as `boundary_hits` leaves
out ADC counts on a .5 boundary; under capacity dispatch so is every
token routed to either contested expert (its place in the group may
move), and in `lm_forward` the rest of that sequence (attention carries
the difference forward). The seeds are not chosen around them.

Packed path: a reduced smoke deepseek (1 layer, 4 experts, top-2, f32)
deployed `ideal` by the reference (its calibration batches rebuilt from
its keys and handed to the port: the dense chip through `x_cal`, each
expert chip through `x_cal_experts`) and served (batch 2, prompt 8, 4
tokens) by both: every (layer, expert) chip's plan and index maps exact,
tiles equal, logits within LOGIT_ATOL (tests/test_torch_serve.py), greedy
tokens equal; then the port's continuous-batching engine (dropless, the
plain versions on the CPU) returns each request's tokens as the request
served alone does.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_chip_match, reference_x_cal, to_numpy,
                           to_torch)

from repro import configs as jconfigs
from repro.data import lm_tokens
from repro.launch.steps import arch_serving, make_decode_step
from repro.models import moe as jmoe
from repro.models import nn as jnn
from repro.models import transformer as jT
from repro.obs.chipmeter import ChipMeter as JChipMeter
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.core.verify import ChipVerifyError, verify_deployed
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.launch import scheduler as S
from repro_torch.launch import serve as tserve
from repro_torch.models import moe as tmoe
from repro_torch.models import nn as tnn
from repro_torch.models import transformer as tT
from repro_torch.obs.chipmeter import ChipMeter

MOE_ATOL = 1e-5
LOGIT_ATOL = 1e-4
B, S_LEN, GEN = 2, 8, 4
DEEPSEEK, LLAMA4 = "deepseek-moe-16b", "llama4-maverick-400b-a17b"
REDUCED = dict(n_layers=1, n_experts=4, top_k=2)


def _configs(arch, **kw):
    """The reference's and the port's smoke config of `arch` in f32."""
    jc = jconfigs.get(arch, smoke=True).replace(dtype=jnp.float32, **kw)
    tc = tconfigs.get(arch, smoke=True).replace(dtype=torch.float32, **kw)
    return jc, tc


def near_ties(x2, router_w, k):
    """(T,) bool: tokens whose k-th and (k+1)-th router logits lie within
    TIE_BAND, and (T, 2) the two contested experts. Float64 numpy."""
    x2 = np.asarray(x2, np.float64)
    w = np.asarray(router_w, np.float64)
    logits = x2 @ w
    band = 4 * (x2.shape[1] + 2) * 2.0 ** -24 * (np.abs(x2) @ np.abs(w))
    order = np.argsort(-logits, axis=1, kind="stable")
    rows = np.arange(len(x2))
    a, b = order[:, k - 1], order[:, k]
    gap = logits[rows, a] - logits[rows, b]
    tie = gap <= np.maximum(band[rows, a], band[rows, b])
    return tie, np.stack([a, b], axis=1), order[:, :k]


def _layer0(pnp):
    return {k: v[0] for k, v in pnp["layers"].items()}


@pytest.mark.parametrize("mode", ["cf1", "cf16", "dropless"])
def test_moe_ffn_float_matches_reference(mode):
    """The sort-based dispatch on the float path: routes dropped at
    capacity factor 1, none at 16, dropless."""
    jc, tc = _configs(DEEPSEEK, moe_dropless=mode == "dropless")
    cf = {"cf1": 1.0, "cf16": 16.0, "dropless": 1.25}[mode]
    params = jT.init_params(jax.random.PRNGKey(3), jc)
    p = _layer0(jax.tree_util.tree_map(np.asarray, params))
    x = np.random.default_rng(0).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    want = np.asarray(jmoe.moe_ffn(jax.tree_util.tree_map(jnp.asarray, p),
                                   jnp.asarray(x), jc, capacity_factor=cf))
    got = to_numpy(tmoe.moe_ffn(params_from_numpy(p), to_torch(x), tc,
                                capacity_factor=cf))
    x2 = x.reshape(-1, jc.d_model)
    tie, contested, chosen = near_ties(x2, p["router"], jc.top_k)
    clean = ~tie
    if mode == "cf1" and tie.any():
        hit = np.isin(chosen, contested[tie].ravel()).any(axis=1)
        clean &= ~hit
    if mode == "cf1":        # routes were dropped: the capacity path ran
        assert tmoe.capacity(x2.shape[0], tc, cf) < x2.shape[0] * jc.top_k
    assert clean.sum() >= 0.9 * len(clean)
    np.testing.assert_allclose(got.reshape(x2.shape)[clean],
                               want.reshape(x2.shape)[clean], rtol=0,
                               atol=MOE_ATOL)


def _lm_ties(tc, tparams, tokens, dropless):
    """(B, S) bool: positions the float lm_forward comparison keeps, from
    the port's router inputs (recorded through `moe._router`)."""
    seen = []
    orig = tmoe._router

    def spy(x2, w, k):
        seen.append((to_numpy(x2), to_numpy(w), k))
        return orig(x2, w, k)
    tmoe._router = spy
    try:
        tT.lm_forward(tparams, tokens, tc)
    finally:
        tmoe._router = orig
    b, s = tokens.shape
    keep = np.ones((b, s), bool)
    for x2, w, k in seen:
        tie, contested, chosen = near_ties(x2, w, k)
        dirty = tie.copy()
        if not dropless and tie.any():
            dirty |= np.isin(chosen, contested[tie].ravel()).any(axis=1)
        for i in np.flatnonzero(dirty):
            keep[i // s, i % s:] = False
    return keep


@pytest.mark.parametrize("arch", [DEEPSEEK, LLAMA4])
def test_lm_forward_float_matches_reference(arch):
    """The whole model teacher-forced, cim_mode off: deepseek's MoE on
    every layer, llama4's 1:1 interleave (dense first, then MoE) with
    top-1 routing and an untied unembedding."""
    jc, tc = _configs(arch)
    params = jT.init_params(jax.random.PRNGKey(2), jc)
    pnp = jax.tree_util.tree_map(np.asarray, params)
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (2, 12))
    want = np.asarray(jax.jit(lambda p, t: jT.lm_forward(p, t, jc))(
        params, jnp.asarray(tokens, jnp.int32)))
    tparams = params_from_numpy(pnp)
    ttok = to_torch(tokens).long()
    got = to_numpy(tT.lm_forward(tparams, ttok, tc))
    keep = _lm_ties(tc, tparams, ttok, jc.moe_dropless)
    assert keep.mean() >= 0.75
    np.testing.assert_allclose(got[keep], want[keep], rtol=0,
                               atol=LOGIT_ATOL)


def test_init_params_layout_matches_reference():
    """The port's random params have the reference's tree and shapes:
    untied `unembed`, llama4's `dense_layers` (an MLP) beside `layers`
    (router, routed and shared experts)."""
    for arch in (DEEPSEEK, LLAMA4):
        jc, tc = _configs(arch)
        want = jax.tree_util.tree_map(
            lambda a: tuple(a.shape),
            jax.eval_shape(lambda: jT.init_params(jax.random.PRNGKey(0),
                                                  jc)))
        got = tT.init_params(tc, seed=0, device="cpu")
        shapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                      if isinstance(v, dict) else tuple(v.shape))
                  for k, v in got.items()}
        assert shapes == want


def test_params_from_numpy_carries_moe_trees():
    """router, routed (L, E, in, out) and shared experts, the interleave's
    dense layers and the untied unembedding come across as f32 tensors."""
    jc, _ = _configs(LLAMA4)
    pnp = jax.tree_util.tree_map(
        np.asarray, jT.init_params(jax.random.PRNGKey(0), jc))
    t = params_from_numpy(pnp)
    for path in (("unembed",), ("layers", "router"), ("layers", "ew_g"),
                 ("layers", "sw_o"), ("dense_layers", "w_g")):
        a, b = pnp, t
        for k in path:
            a, b = a[k], b[k]
        assert b.dtype == torch.float32
        np.testing.assert_array_equal(to_numpy(b), a)


def test_router_rows_do_not_depend_on_the_batch():
    """A token's routing (experts and gates, bit for bit) is the same
    whether it is routed alone or with other tokens: the router's sums run
    in float64, so a pool slot routes as the request served alone does
    (deepseek-moe-16b's full-width router, d 2048 and 64 experts, where a
    float32 GEMM's rows do depend on the batch)."""
    rng = np.random.default_rng(6)
    w = to_torch((rng.standard_normal((2048, 64)) / 45).astype(np.float32))
    x2 = to_torch(rng.standard_normal((48, 2048)).astype(np.float32))
    gate, idx = tmoe._router(x2, w, 6)
    for i in range(x2.shape[0]):
        g1, i1 = tmoe._router(x2[i:i + 1], w, 6)
        assert torch.equal(i1[0], idx[i]) and torch.equal(g1[0], gate[i]), i


def test_capacity_matches_reference_formula():
    import math
    _, tc = _configs(DEEPSEEK)
    for t in (1, 4, 7, 30, 256):
        for cf in (1.0, 1.25, 16.0):
            want = min(max(int(math.ceil(t * tc.top_k / tc.n_experts * cf)),
                           4), t * tc.top_k)
            assert tmoe.capacity(t, tc, cf) == want
    assert tmoe.capacity(9, tc.replace(moe_dropless=True)) == 9


def test_engine_forces_dropless():
    """The continuous-batching engine serves an MoE arch dropless, as the
    reference's engine does."""
    cfg = tserve.serving_config(DEEPSEEK, smoke=True).replace(n_layers=1)
    params = tT.init_params(cfg, seed=0, device="cpu")
    eng = S.ContinuousBatchingEngine(cfg, params, n_slots=2, max_len=16)
    assert eng.cfg.moe_dropless and not cfg.moe_dropless


# ------------------------------------------------------------ packed path

def reference_expert_x_cal(key, expert_stacked, in_alpha):
    """The calibration batches the reference's expert deploy draws
    (deploy_transformer_cim: expert e's stack through deploy_packed_stack
    at fold_in(key, 7919 + e)), as a per-layer, per-expert list of
    name -> numpy (64, R)."""
    names = sorted(expert_stacked)
    n_layers, n_experts = expert_stacked[names[0]].shape[:2]
    out = [[None] * n_experts for _ in range(n_layers)]
    for e in range(n_experts):
        k_exp = jax.random.fold_in(key, 7919 + e)
        for li in range(n_layers):
            k_layer = jax.random.fold_in(k_exp, li)
            batches = {}
            for i, n in enumerate(names):
                _, k_syn = jax.random.split(jax.random.fold_in(k_layer, i))
                batches[n] = np.array(in_alpha * jax.random.truncated_normal(
                    k_syn, -2.0, 2.0, (64, expert_stacked[n].shape[2])))
            out[li][e] = batches
    return out


@pytest.fixture(scope="module")
def served():
    jc = jconfigs.get(DEEPSEEK, smoke=True).replace(
        dtype=jnp.float32, cim_mode="packed", cim_mesh=None, **REDUCED)
    sv = arch_serving(jc)
    params = sv.init_params(jax.random.PRNGKey(0))
    deployed = jnn.deploy_transformer_cim(jax.random.PRNGKey(7), params, jc,
                                          mode="ideal")
    prompts = lm_tokens(jax.random.PRNGKey(1), B, S_LEN, jc.vocab)
    logits, cache = jax.jit(sv.prefill)(deployed,
                                        sv.init_state(B, S_LEN + GEN),
                                        prompts)
    decode = jax.jit(make_decode_step(jc))
    toks, ref_logits = [jnp.argmax(logits, -1)[:, None]], [logits]
    for _ in range(GEN - 1):
        logits, cache = decode(deployed, cache, {"tokens": toks[-1]})
        toks.append(jnp.argmax(logits, -1)[:, None])
        ref_logits.append(logits)

    pnp = jax.tree_util.tree_map(np.asarray, params)
    lay = pnp["layers"]
    x_cal = reference_x_cal(jax.random.PRNGKey(7), {
        n: lay[n] for n in tnn.PACKED_PROJ_KEYS if n in lay}, 3.0)
    x_cal_e = reference_expert_x_cal(jax.random.PRNGKey(7), {
        n: lay[n] for n in tnn.PACKED_EXPERT_KEYS}, 3.0)
    tcfg = tserve.serving_config(DEEPSEEK, smoke=True, cim=True).replace(
        **REDUCED)
    launches = sum(K.LAUNCHES.values())
    tparams = tnn.deploy_transformer_cim(
        params_from_numpy(pnp), tcfg, mode="ideal", x_cal=x_cal,
        x_cal_experts=x_cal_e)
    out = tserve.greedy_decode(tparams, tcfg,
                               to_torch(np.asarray(prompts)).long(), GEN,
                               torch.device("cpu"))
    return {"ref_tokens": np.asarray(jnp.concatenate(toks, axis=1)),
            "ref_logits": [np.asarray(v) for v in ref_logits],
            "ref_deployed": deployed, "out": out, "tparams": tparams,
            "tcfg": tcfg, "launches": sum(K.LAUNCHES.values()) - launches}


def test_packed_greedy_tokens_equal(served):
    assert to_numpy(served["out"].tokens).tolist() == \
        served["ref_tokens"].tolist()


def test_packed_logits_allclose(served):
    got = served["out"].logits
    assert len(got) == GEN
    for step, (g, want) in enumerate(zip(got, served["ref_logits"])):
        np.testing.assert_allclose(to_numpy(g), want, rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"token {step}")


def test_packed_launches_no_kernel_on_cpu(served):
    assert served["launches"] == 0


@pytest.mark.parametrize("name", tnn.PACKED_EXPERT_KEYS)
def test_expert_chips_match(served, name):
    """Every (layer, expert) chip: plan and index maps exact, programmed
    tiles equal, calibrated tensors to f32 rounding."""
    ref = served["ref_deployed"]["layers"][name + "_cim"]
    ours = served["tparams"]["layers"][name + "_cim"]
    n_l, n_e = REDUCED["n_layers"], REDUCED["n_experts"]
    assert len(ours) == n_l and all(len(row) == n_e for row in ours)
    for li in range(n_l):
        for e in range(n_e):
            pj = jax.tree_util.tree_map(lambda a: np.asarray(a)[li, e], ref)
            assert_chip_match(ours[li][e], pj, f"{name} layer {li} "
                                               f"expert {e}")


@pytest.mark.parametrize("name", ["wq", "wk", "wv", "wo", "sw_g", "sw_i",
                                  "sw_o"])
def test_layer_chips_match(served, name):
    """The layer chip carries the attention and shared-expert projections,
    as the reference's does."""
    spl = served["ref_deployed"]["layers"][name + "_cim"]
    for li, pcl in enumerate(served["tparams"]["layers"][name + "_cim"]):
        pj = jax.tree_util.tree_map(lambda a: np.asarray(a)[li, 0],
                                    spl.shards)
        assert_chip_match(pcl, pj, f"{name} layer {li}")


def test_chip_meter_counts_every_expert_chip(served):
    """The chip meter's entries equal the reference's: an expert stack
    stands for layers x experts chips (all E per token, not the top-k)."""
    tc = served["tcfg"]
    want = JChipMeter.from_params(served["ref_deployed"], tc.cim_in_bits,
                                  tc.cim_out_bits)
    got = ChipMeter.from_params(served["tparams"], tc.cim_in_bits,
                                tc.cim_out_bits)
    strip = lambda m: {k: (e.rows, e.cols, e.n_stack)
                       for k, e in m.entries.items()}
    assert strip(got) == strip(want)
    assert got.entries[("layers/ew_g", "fwd")].n_stack == \
        REDUCED["n_layers"] * REDUCED["n_experts"]


def test_verifier_rejects_mismatched_expert_chip(served):
    """stack-geometry: an expert chip whose plan differs from its stack's
    is named before anything launches."""
    layers = dict(served["tparams"]["layers"])
    row = list(layers["ew_g_cim"][0])
    bad = row[1].packed
    row[1] = row[1]._replace(packed=type(bad)(
        **{f: getattr(bad, f) for f in (
            "layer", "bk", "bn", "n_rows", "n_cols", "row_block",
            "col_block", "seq_slot", "n_passes", "transpose", "tile_slot",
            "out_slot", "out_col", "gd_tiles", "inv_norm_tiles",
            "v_decr_tiles")},
        denorm_tiles=bad.denorm_tiles[:, :, :-1]))
    layers["ew_g_cim"] = [row]
    with pytest.raises(ChipVerifyError, match="stack-geometry"):
        verify_deployed({"layers": layers})


def test_pool_tokens_equal_alone(served):
    """The port's engine (dropless, plain versions on the CPU): each
    request's tokens equal the request served alone on the static path
    with the engine's config; logits within LOGIT_ATOL."""
    tc, tparams = served["tcfg"], served["tparams"]
    rng = np.random.default_rng(5)
    lens, gens = [32, 16, 48, 32], [4, 6, 3, 5]
    reqs = [S.Request(rid=i, prompt=rng.integers(0, tc.vocab, (n,))
                      .astype(np.int32), max_new=g)
            for i, (n, g) in enumerate(zip(lens, gens))]
    eng = S.ContinuousBatchingEngine(tc, tparams, n_slots=2, max_len=64,
                                     chunk=16, capture_logits=True)
    eng.run(reqs, realtime=False)
    for r in reqs:
        g = tserve.greedy_decode(tparams, eng.cfg,
                                 torch.as_tensor(r.prompt[None]).long(),
                                 r.max_new, torch.device("cpu"),
                                 max_len=eng.max_len)
        assert g.tokens[0].tolist() == r.tokens, r.rid
        for a, b in zip(r.logits, g.logits):
            np.testing.assert_allclose(a, to_numpy(b[0]), rtol=0,
                                       atol=LOGIT_ATOL)


def test_deploy_rejects_unknown_alpha_name():
    """A per-name in_alpha dict that names no projection raises, with the
    reference's message."""
    cfg = tserve.serving_config(DEEPSEEK, smoke=True, cim=True).replace(
        **REDUCED)
    params = tT.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="match no projection"):
        tnn.deploy_transformer_cim(params, cfg, in_alpha={"w_q": 2.0})


def test_per_name_alpha_reaches_expert_and_layer_chips():
    """A dict over both groups deploys each projection at its own clip;
    a name it leaves out takes 1.0."""
    cfg = tserve.serving_config(DEEPSEEK, smoke=True, cim=True).replace(
        **REDUCED)
    params = tT.init_params(cfg, seed=0, device="cpu")
    dep = tnn.deploy_transformer_cim(params, cfg,
                                     in_alpha={"ew_g": 2.5, "wq": 4.0})
    lay = dep["layers"]
    alpha = lambda pcl: float(pcl.layer.in_alpha)
    assert alpha(lay["wq_cim"][0]) == 4.0
    assert alpha(lay["wk_cim"][0]) == 1.0
    assert {alpha(c) for c in lay["ew_g_cim"][0]} == {2.5}
    assert {alpha(c) for c in lay["ew_o_cim"][0]} == {1.0}

"""Port parity, the recurrent family (`repro_torch/models/rwkv6.py`,
`models/mamba2.py`, the family dispatch of `models/transformer.py`, the
recurrent deploy of `models/nn.py`): the JAX reference and the port on the
CPU, from the same numpy inputs and params, at the SMOKE configs —
rwkv6-7b, zamba2-7b (6 layers: 2 groups of 3, each followed by the shared
attention block) and zamba2 with the block off (`hybrid_attn_every=0`).

Float path (cim_mode "off", f32): the whole model teacher-forced
(`lm_forward`) over 80 tokens (rwkv6: two full scan chunks of 32 and one
padded; mamba2: one of 64 and one padded), then a 20-token prefill and 4
decode steps: logits within LOGIT_ATOL = 1e-4, the carried state within
STATE_RTOL = 5e-5 of its largest magnitude. The two packages round in
another order (torch contracts the scans' three- and four-operand einsums
in its own order), and each is as far as the other from the exact result:
against the port evaluated in float64, the reference's f32 logits of
rwkv6's 80-token forward are off by 2.6e-5 (the port's by 2.1e-6) on
logits of up to 1.05, and both packages' mamba2 h after 20 tokens by up
to 4.7e-6 of its largest magnitude (16.7), on the CPU.

Packed path: each arch deployed `ideal` by the reference's
`deploy_recurrent_cim` (`cim_mesh=None`: on jax 0.9 the reference's meshed
path fails), its calibration batches rebuilt from its keys and handed to
the port (`x_cal`, and `x_cal_shared` for zamba2's shared block, key
fold_in(7, 104729)); prompts of 72 tokens (batch 2), 4 generated tokens.
Every chip's plan and index maps exact and its tiles equal; greedy tokens
equal and logits within LOGIT_ATOL = 1e-4 (tests/test_torch_serve.py: a
flipped 4-bit input level or ADC count moves a projection by about 1% of
its range, far above it); no kernel launched on the CPU. Then the port
alone: chunked prefill + decode against a one-shot prefill, the engine's
pool against each request served alone, a decode step's rows against
each row stepped alone (state bit for bit, logits within UNEMBED_ATOL), a
frozen slot's state.

Every test runs at one torch thread (a module fixture), as the training
files do.
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
from repro.models import nn as jnn
from repro.models import transformer as jT
from repro.obs.chipmeter import ChipMeter as JChipMeter
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.launch import scheduler as S
from repro_torch.launch import serve as tserve
from repro_torch.models import nn as tnn
from repro_torch.models import transformer as tT
from repro_torch.obs.chipmeter import ChipMeter

LOGIT_ATOL = 1e-4
STATE_RTOL = 5e-5
# one float32 dot of d = 128 terms in another order, on O(1) logits:
# 128 * 2^-24 ~ 7.6e-6 at the worst (3.6e-7 measured on the CPU)
UNEMBED_ATOL = 1e-5
B, S_LEN, GEN = 2, 72, 4
RWKV, ZAMBA = "rwkv6-7b", "zamba2-7b"
# arch name, config overrides
FLOAT_CASES = {"rwkv6": (RWKV, {}), "zamba2": (ZAMBA, {}),
               "zamba2-noattn": (ZAMBA, {"hybrid_attn_every": 0})}
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the scans are loops of small eager ops, and the
    suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _configs(arch, **kw):
    """The reference's and the port's smoke config of `arch` in f32."""
    jc = jconfigs.get(arch, smoke=True).replace(dtype=jnp.float32, **kw)
    tc = tconfigs.get(arch, smoke=True).replace(dtype=torch.float32, **kw)
    return jc, tc


def _params(jc, seed):
    params = jT.init_params(jax.random.PRNGKey(seed), jc)
    return params, params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                            params))


def _state_keys(tc):
    return ("S", "x_tm", "x_cm") if tc.rwkv else \
        ("h", "ak", "av") if tc.hybrid_attn_every else ("h",)


# ----------------------------------------------------------------- float

@pytest.mark.parametrize("case", list(FLOAT_CASES))
def test_lm_forward_float_matches_reference(case):
    arch, kw = FLOAT_CASES[case]
    jc, tc = _configs(arch, **kw)
    params, tparams = _params(jc, 2)
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (2, 80))
    want = np.asarray(jax.jit(lambda p, t: jT.lm_forward(p, t, jc))(
        params, jnp.asarray(tokens, jnp.int32)))
    got = to_numpy(tT.lm_forward(tparams, to_torch(tokens).long(), tc))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=LOGIT_ATOL)


@pytest.mark.parametrize("case", list(FLOAT_CASES))
def test_prefill_decode_float_matches_reference(case):
    """A 20-token prefill, then 4 decode steps: every step's logits and
    the carried state (S / x_tm / x_cm, h, the shared block's KV)."""
    arch, kw = FLOAT_CASES[case]
    jc, tc = _configs(arch, **kw)
    params, tparams = _params(jc, 3)
    tokens = np.random.default_rng(2).integers(0, jc.vocab, (2, 24))
    jt = jnp.asarray(tokens, jnp.int32)
    state = jT.init_cache(jc, 2, 32)
    lg, state = jax.jit(lambda p, t, s: jT.prefill(p, t, s, jc))(
        params, jt[:, :20], state)
    want = [np.asarray(lg)]
    dec = jax.jit(lambda p, s, t: jT.decode_step(p, s, t, jc))
    for i in range(20, 24):
        lg, state = dec(params, state, jt[:, i:i + 1])
        want.append(np.asarray(lg))
    tt = to_torch(tokens).long()
    tstate = tT.init_cache(tc, 2, 32, device="cpu")
    lg, tstate = tT.prefill(tparams, tt[:, :20], tstate, tc)
    got = [to_numpy(lg)]
    for i in range(20, 24):
        lg, tstate = tT.decode_step(tparams, tstate, tt[:, i:i + 1], tc)
        got.append(to_numpy(lg))
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=0, atol=LOGIT_ATOL,
                                   err_msg=f"step {step}")
    assert tstate["len"] == int(state["len"]) == 24
    for k in _state_keys(tc):
        want = np.asarray(state[k])
        np.testing.assert_allclose(to_numpy(tstate[k]), want, rtol=0,
                                   atol=STATE_RTOL * np.abs(want).max(),
                                   err_msg=k)


def test_init_params_layout_matches_reference():
    """The port's random params have the reference's tree and shapes:
    rwkv6's and mamba2's layer stacks, zamba2's unstacked shared block."""
    for arch in (RWKV, ZAMBA):
        jc, tc = _configs(arch)
        want = jax.tree_util.tree_map(
            lambda a: tuple(a.shape),
            jax.eval_shape(lambda: jT.init_params(jax.random.PRNGKey(0),
                                                  jc)))
        got = tT.init_params(tc, seed=0, device="cpu")
        shapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                      if isinstance(v, dict) else tuple(v.shape))
                  for k, v in got.items()}
        assert shapes == want, arch


def test_init_cache_layout_matches_reference():
    """The state's leaves and shapes, the slot (batch) dim at axis 1."""
    for case in FLOAT_CASES.values():
        jc, tc = _configs(case[0], **case[1])
        want = {k: tuple(v.shape) for k, v in jT.init_cache(jc, 3, 16).items()
                if k != "len"}
        got = tT.init_cache(tc, 3, 16, device="cpu")
        assert {k: tuple(v.shape) for k, v in got.items()
                if k != "len"} == want
        assert got["len"] == 0


def test_params_from_numpy_carries_recurrent_trees():
    for arch, paths in ((RWKV, (("layers", "mu"), ("layers", "cmu"),
                                ("layers", "u"), ("layers", "w_lora_a"))),
                        (ZAMBA, (("layers", "a_log"), ("layers", "dt_bias"),
                                 ("layers", "dd"), ("shared_attn", "wq"),
                                 ("shared_attn", "w_o")))):
        jc, _ = _configs(arch)
        pnp = jax.tree_util.tree_map(
            np.asarray, jT.init_params(jax.random.PRNGKey(0), jc))
        t = params_from_numpy(pnp)
        for path in paths:
            a, b = pnp, t
            for k in path:
                a, b = a[k], b[k]
            assert b.dtype == torch.float32
            np.testing.assert_array_equal(to_numpy(b), a)


# ------------------------------------------------------------ packed path

def _reference_x_cal(pnp, jc):
    """The calibration batches the reference's deploy_recurrent_cim draws
    at key 7: the layer chips' (per-name clips, `cv` at 3 ** 2) and the
    shared block's (key fold_in(7, 104729), a one-layer stack)."""
    lay = pnp["layers"]
    names = jnn.recurrent_proj_keys(jc)
    stacked = {n: lay[n] for n in names}
    alphas = {n: 9.0 if n == "cv" else 3.0 for n in names}
    x_cal = reference_x_cal(jax.random.PRNGKey(7), stacked, alphas)
    x_sa = None
    if "shared_attn" in pnp:
        sa = pnp["shared_attn"]
        x_sa = reference_x_cal(
            jax.random.fold_in(jax.random.PRNGKey(7), 104729),
            {n: sa[n][None] for n in tnn.PACKED_PROJ_KEYS if n in sa}, 3.0)
    return x_cal, x_sa


@pytest.fixture(scope="module", params=[RWKV, ZAMBA])
def served(request):
    arch = request.param
    jc = jconfigs.get(arch, smoke=True).replace(
        dtype=jnp.float32, cim_mode="packed", cim_mesh=None)
    params = jT.init_params(jax.random.PRNGKey(0), jc)
    deployed = jnn.deploy_recurrent_cim(jax.random.PRNGKey(7), params, jc,
                                        mode="ideal")
    prompts = lm_tokens(jax.random.PRNGKey(1), B, S_LEN, jc.vocab)
    logits, state = jax.jit(lambda p, t, s: jT.prefill(p, t, s, jc))(
        deployed, prompts, jT.init_cache(jc, B, S_LEN + GEN))
    decode = jax.jit(lambda p, s, t: jT.decode_step(p, s, t, jc))
    toks, ref_logits = [jnp.argmax(logits, -1)[:, None]], [logits]
    for _ in range(GEN - 1):
        logits, state = decode(deployed, state, toks[-1])
        toks.append(jnp.argmax(logits, -1)[:, None])
        ref_logits.append(logits)

    pnp = jax.tree_util.tree_map(np.asarray, params)
    x_cal, x_sa = _reference_x_cal(pnp, jc)
    tcfg = tserve.serving_config(arch, smoke=True, cim=True)
    launches = sum(K.LAUNCHES.values())
    tparams = tnn.deploy_recurrent_cim(params_from_numpy(pnp), tcfg,
                                       mode="ideal", x_cal=x_cal,
                                       x_cal_shared=x_sa)
    out = tserve.greedy_decode(tparams, tcfg,
                               to_torch(np.asarray(prompts)).long(), GEN,
                               CPU)
    return {"arch": arch, "jc": jc,
            "ref_tokens": np.asarray(jnp.concatenate(toks, axis=1)),
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


def test_layer_chips_match(served):
    """Every projection's chip on every layer: plan and index maps exact,
    tiles equal, calibrated tensors to f32 rounding; rwkv6's `cv` at the
    squared clip."""
    names = jnn.recurrent_proj_keys(served["jc"])
    lay, ref = served["tparams"]["layers"], served["ref_deployed"]["layers"]
    assert sorted(k for k in lay if k.endswith("_cim")) == \
        sorted(n + "_cim" for n in names)
    for n in names:
        spl = ref[n + "_cim"]
        assert len(lay[n + "_cim"]) == served["tcfg"].n_layers
        for li, pcl in enumerate(lay[n + "_cim"]):
            pj = jax.tree_util.tree_map(lambda a: np.asarray(a)[li, 0],
                                        spl.shards)
            assert_chip_match(pcl, pj, f"{n} layer {li}")
            assert float(pcl.layer.in_alpha) == \
                float(np.asarray(pj.layer.in_alpha)) == \
                (9.0 if n == "cv" else 3.0)


def test_shared_block_chip_unstacked(served):
    """zamba2's shared attention block: one chip, its entries bare
    PackedCIMLayers (no layer dim), equal to the reference's."""
    if served["arch"] != ZAMBA:
        assert "shared_attn" not in served["tparams"]
        return
    sa = served["tparams"]["shared_attn"]
    ref = served["ref_deployed"]["shared_attn"]
    cims = sorted(k for k in sa if k.endswith("_cim"))
    assert cims == sorted(n + "_cim" for n in tnn.PACKED_PROJ_KEYS
                          if n in sa)
    for k in cims:
        assert not isinstance(sa[k], list)
        pj = jax.tree_util.tree_map(lambda a: np.asarray(a)[0],
                                    ref[k].shards)
        assert_chip_match(sa[k], pj, f"shared_attn {k}")


def test_chip_meter_matches_reference(served):
    """The chip meter's entries equal the reference's: shared_attn/* once
    per token (n_stack 1)."""
    tc = served["tcfg"]
    want = JChipMeter.from_params(served["ref_deployed"], tc.cim_in_bits,
                                  tc.cim_out_bits)
    got = ChipMeter.from_params(served["tparams"], tc.cim_in_bits,
                                tc.cim_out_bits)
    strip = lambda m: {k: (e.rows, e.cols, e.n_stack)
                       for k, e in m.entries.items()}
    assert strip(got) == strip(want)
    if served["arch"] == ZAMBA:
        assert got.entries[("shared_attn/wq", "fwd")].n_stack == 1


def test_packed_chunked_prefill_continuity(served):
    """A 20-token prefill and 4 decode steps against a one-shot prefill of
    all 24 tokens, every projection on the chips (the reference's
    continuity test: relative error below 1e-3)."""
    tc, tp = served["tcfg"], served["tparams"]
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        0, tc.vocab, (2, 24)))
    state = tT.init_cache(tc, 2, 32, device="cpu")
    lg, state = tT.prefill(tp, toks[:, :20], state, tc)
    for t in range(20, 24):
        lg, state = tT.decode_step(tp, state, toks[:, t:t + 1], tc)
    full, _ = tT.prefill(tp, toks, tT.init_cache(tc, 2, 32, device="cpu"),
                         tc)
    assert bool(torch.isfinite(lg).all())
    rel = float((lg - full).abs().max() / (full.abs().max() + 1e-9))
    assert rel < 1e-3, rel


def _pool_requests(tc, arch):
    """Prompts in whole scan chunks of the engine's chunk (rwkv6 32, zamba2
    64), so the pool's prefill chunks are the one-shot prefill's."""
    chunk = 32 if arch == RWKV else 64
    lens = [chunk, 2 * chunk, chunk, 3 * chunk] if arch == RWKV \
        else [chunk, 2 * chunk, chunk]
    rng = np.random.default_rng(5)
    reqs = [S.Request(rid=i, prompt=rng.integers(0, tc.vocab, (n,))
                      .astype(np.int32), max_new=g)
            for i, (n, g) in enumerate(zip(lens, [4, 6, 3, 5]))]
    return reqs, chunk


def test_pool_tokens_equal_alone(served):
    """The port's engine (plain versions on the CPU): each request's tokens
    equal the request served alone on the static path; logits within
    LOGIT_ATOL."""
    tc, tp = served["tcfg"], served["tparams"]
    reqs, chunk = _pool_requests(tc, served["arch"])
    eng = S.ContinuousBatchingEngine(tc, tp, n_slots=2, max_len=3 * chunk
                                     + 8, chunk=chunk, capture_logits=True)
    st = eng.run(reqs, realtime=False)
    assert st["decode_traces"] == 1
    for r in reqs:
        g = tserve.greedy_decode(tp, eng.cfg,
                                 torch.as_tensor(r.prompt[None]).long(),
                                 r.max_new, CPU, max_len=eng.max_len)
        assert g.tokens[0].tolist() == r.tokens, r.rid
        for a, b in zip(r.logits, g.logits):
            np.testing.assert_allclose(a, to_numpy(b[0]), rtol=0,
                                       atol=LOGIT_ATOL)


def test_decode_rows_do_not_depend_on_the_batch(served):
    """A decode step over 4 rows leaves each row's state as that row
    stepped alone does, bit for bit: the float sums outside the chips run
    in float64 (`models/rwkv6.py`), so a slot's state does not depend on
    how many slots share the step. The logits then pass the float32
    unembedding, a GEMM whose summation order does depend on the rows:
    within UNEMBED_ATOL."""
    tc, tp = served["tcfg"], served["tparams"]
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab, (4, 10)))
    state = tT.init_cache(tc, 4, 16, device="cpu")
    _, state = tT.prefill(tp, toks[:, :9], state, tc)
    rows = [{k: (v if k == "len" else v[:, i:i + 1].clone())
             for k, v in state.items()} for i in range(4)]
    lg, state = tT.decode_step(tp, state, toks[:, 9:], tc)
    for i, row in enumerate(rows):
        lg_i, row = tT.decode_step(tp, row, toks[i:i + 1, 9:], tc)
        for k in _state_keys(tc):
            assert torch.equal(row[k][:, 0], state[k][:, i]), (i, k)
        np.testing.assert_allclose(to_numpy(lg_i[0]), to_numpy(lg[i]),
                                   rtol=0, atol=UNEMBED_ATOL)


def test_frozen_slot_state_unchanged(served):
    """A slot whose `active` bit is off keeps its S / h (and the hybrid's
    KV) bit for bit across decode steps, while a live slot's moves."""
    tc, tp = served["tcfg"], served["tparams"]
    reqs, chunk = _pool_requests(tc, served["arch"])
    eng = S.ContinuousBatchingEngine(tc, tp, n_slots=2, max_len=2 * chunk
                                     + 8, chunk=chunk)
    eng.warmup({chunk})
    for r in reqs[:2]:
        eng._admit(S.Request(rid=r.rid, prompt=r.prompt, max_new=8))
    while eng._jobs:
        eng._prefill_one_chunk(0.0)
    eng._activate(eng.pool, 0, False)
    keys = _state_keys(tc)
    before = {k: eng.pool[k].clone() for k in keys + ("len", "tok")}
    for _ in range(3):
        eng.stripes[0].decode(tp, eng.pool)
    for k in keys:
        assert torch.equal(eng.pool[k][:, 0], before[k][:, 0]), k
    main = keys[0]
    assert not torch.equal(eng.pool[main][:, 1], before[main][:, 1])
    assert int(eng.pool["len"][0]) == int(before["len"][0])
    assert int(eng.pool["len"][1]) == int(before["len"][1]) + 3


# --------------------------------------------------------------- dispatch

def test_deploy_cim_routes_each_family():
    """deploy_cim sends a recurrent arch to deploy_recurrent_cim and a
    dense one to deploy_transformer_cim."""
    for arch, keys in ((RWKV, tnn.RWKV_PROJ_KEYS),
                       (ZAMBA, tnn.MAMBA_PROJ_KEYS),
                       ("gemma2-9b", ("wq", "wk", "wv", "wo", "w_g", "w_i",
                                      "w_o"))):
        cfg = tserve.serving_config(arch, smoke=True, cim=True).replace(
            n_layers=1 if arch != ZAMBA else 3)
        assert tnn.is_recurrent_arch(cfg) == (arch != "gemma2-9b")
        dep = tnn.deploy_cim(tT.init_params(cfg, seed=0, device="cpu"), cfg)
        assert sorted(k for k in dep["layers"] if k.endswith("_cim")) == \
            sorted(n + "_cim" for n in keys), arch


def test_deploy_recurrent_rejects_dense_arch():
    cfg = tserve.serving_config("gemma2-9b", smoke=True, cim=True)
    params = tT.init_params(cfg.replace(n_layers=1), seed=0, device="cpu")
    with pytest.raises(ValueError, match="not a recurrent arch"):
        tnn.deploy_recurrent_cim(params, cfg)
    with pytest.raises(ValueError, match="deploy_recurrent_cim"):
        tnn.deploy_transformer_cim(
            tT.init_params(tconfigs.get(RWKV, smoke=True), seed=0,
                           device="cpu"), cfg)


def test_deploy_recurrent_rejects_model_width():
    """A 'model' width the serving mesh does not have is refused. A mesh
    with two data rows gives each row a copy of the same chips
    (`nn.row_params`)."""
    from repro_torch.launch.mesh import Mesh
    cfg = tserve.serving_config(RWKV, smoke=True, cim=True)
    params = tT.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(ValueError, match="disagrees with the serving"):
        tnn.deploy_recurrent_cim(params, cfg, mesh_shape={"model": 2},
                                 mesh=Mesh([["cpu"]]))
    dp = tnn.deploy_recurrent_cim(params, cfg, mesh=Mesh([["cpu"], ["cpu"]]))
    assert len(dp["cim_rows"]) == 2
    for r in range(2):
        rp = tnn.row_params(dp, r)
        assert "cim_rows" not in rp
        for n, v in dp["layers"].items():
            if n.endswith("_cim"):
                assert all(torch.equal(a.packed.gd_tiles, b.packed.gd_tiles)
                           for a, b in zip(v, rp["layers"][n])), n


@pytest.mark.parametrize("arch", [RWKV, ZAMBA])
def test_serve_cli_cim_recurrent(arch, capsys):
    """`serve --arch ... --smoke --cim --device cpu` serves and prints the
    compiled stack count (zamba2: the shared block's projections too);
    without --device cpu and without CUDA it raises."""
    toks = tserve.main(["--arch", arch, "--smoke", "--cim", "--device",
                        "cpu", "--batch", "2", "--prompt-len", "8",
                        "--gen", "3"])
    assert tuple(toks.shape) == (2, 3)
    out = capsys.readouterr().out
    n = len(tnn.RWKV_PROJ_KEYS if arch == RWKV else tnn.MAMBA_PROJ_KEYS)
    assert f"compiled {n} projection stacks" in out
    assert ("+ 7 shared-attn projections" in out) == (arch == ZAMBA)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tserve.main(["--arch", arch, "--smoke", "--cim"])

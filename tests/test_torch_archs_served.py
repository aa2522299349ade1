"""Port parity, the dense, VLM and encoder-decoder archs served from their
compiled chips (`--cim`): the JAX reference and the port on the CPU, from
the same params (QKV biases overwritten with seeded nonzero values in
both), calibration batches, prompts and stub-frontend embeddings, at the
SMOKE configs, batch 2, prompt 8, 4 generated tokens:

  * qwen2-72b (GQA, QKV bias) and granite-20b (MQA) on the default
    48-core chip (single-pass plans, the packed kernel's plain version);
  * internvl2-1b (QKV bias, MQA at smoke size): its 16-patch vision
    prefix run into the cache by `steps.make_prefill_step` ahead of the
    prompt, as the reference's prefill step does;
  * seamless-m4t-medium on a 4-core chip (merged cores, the scheduled
    kernel's plain version): its float encoder over 8 source frames, its
    memory cross-attended by every decoder block in prefill and decode.

The reference runs with `cfg.cim_mesh=None`, as tests/test_torch_serve.py
does (its meshed path fails on jax 0.9); its calibration batches are
rebuilt from its keys and handed to the port (`x_cal`). Every chip's plan
and index maps exact and tiles equal; the biases, the cross-attention and
the encoder stay float (no chip); greedy tokens equal and logits within
LOGIT_ATOL = 1e-4 (a flipped 4-bit input level or ADC count moves a
projection by about 1% of its range, far above it); the chip meter's
entries equal the reference's; no kernel launched on the CPU. Then the
port alone, on qwen2-72b's smoke chips (its own seeded params and
biases): the continuous-batching engine, each request equal to it served
alone; a decode step's rows, each equal to the row stepped alone.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (assert_chip_match, frontend_inputs,
                           reference_x_cal, to_numpy, to_torch, with_biases)

from repro import configs as jconfigs
from repro.core.types import CoreSpec as JSpec
from repro.data import lm_tokens
from repro.launch import steps as jsteps
from repro.models import nn as jnn
from repro.models import transformer as jT
from repro.obs.chipmeter import ChipMeter as JChipMeter
from repro_torch.convert import params_from_numpy
from repro_torch.kernels.cim_mvm import kernel as K
from repro_torch.launch import scheduler as S
from repro_torch.launch import serve as tserve
from repro_torch.models import nn as tnn
from repro_torch.models import transformer as tT
from repro_torch.obs.chipmeter import ChipMeter

LOGIT_ATOL = 1e-4
# one float32 dot of d = 128 terms in another order, on O(1) logits:
# 128 * 2^-24 ~ 7.6e-6 at the worst
UNEMBED_ATOL = 1e-5
B, S_LEN, GEN = 2, 8, 4
CPU = torch.device("cpu")
# arch: cores per chip (None: NeuRRAM's 48)
SERVED = {"qwen2-72b": None, "granite-20b": None, "internvl2-1b": None,
          "seamless-m4t-medium": 4}
FLOAT_KEYS = ("bq", "bk", "bv", "xln", "xwq", "xwk", "xwv", "xwo")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One torch thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=list(SERVED))
def served(request):
    arch, cores = request.param, SERVED[request.param]
    jc = jconfigs.get(arch, smoke=True).replace(
        cim_mode="packed", dtype=jnp.float32, cim_mesh=None)
    params = with_biases(jT.init_params(jax.random.PRNGKey(0), jc))
    spec = JSpec(n_cores=cores) if cores else None
    deployed = jnn.deploy_transformer_cim(jax.random.PRNGKey(7), params, jc,
                                          mode="ideal", spec=spec)
    prompts = lm_tokens(jax.random.PRNGKey(1), B, S_LEN, jc.vocab)
    extra = frontend_inputs(jc, B, S_LEN)
    jb = {k: jnp.asarray(v) for k, v in extra.items()}
    cache = jT.init_cache(jc, B, S_LEN + GEN + jc.vis_patches)
    logits, cache = jax.jit(jsteps.make_prefill_step(jc))(
        deployed, cache, dict(jb, tokens=prompts))
    feed = {}
    if jc.enc_layers:
        feed["memory"] = jT._encode(deployed, jb["src_embeds"], jc)
    decode = jax.jit(jsteps.make_decode_step(jc))
    toks, ref_logits = [jnp.argmax(logits, -1)[:, None]], [logits]
    for _ in range(GEN - 1):
        logits, cache = decode(deployed, cache, dict(feed, tokens=toks[-1]))
        toks.append(jnp.argmax(logits, -1)[:, None])
        ref_logits.append(logits)

    pnp = jax.tree_util.tree_map(np.asarray, params)
    stacked = {n: pnp["layers"][n] for n in tnn.PACKED_PROJ_KEYS
               if n in pnp["layers"]}
    x_cal = reference_x_cal(jax.random.PRNGKey(7), stacked, 3.0)
    launches = sum(K.LAUNCHES.values())
    res = tserve.serve_static(
        arch, smoke=True, batch=B, prompt_len=S_LEN, gen=GEN, cim=True,
        device="cpu", params=params_from_numpy(pnp),
        prompts=to_torch(np.asarray(prompts)).long(), x_cal=x_cal,
        cim_cores=cores or 0,
        **{k: to_torch(v) for k, v in extra.items()})
    return {"arch": arch, "jc": jc, "res": res, "ref_deployed": deployed,
            "ref_tokens": np.asarray(jnp.concatenate(toks, axis=1)),
            "ref_logits": [np.asarray(v) for v in ref_logits],
            "launches": sum(K.LAUNCHES.values()) - launches}


def test_served_greedy_tokens_equal(served):
    assert to_numpy(served["res"].out.tokens).tolist() == \
        served["ref_tokens"].tolist()


def test_served_logits_allclose(served):
    got = served["res"].out.logits
    assert len(got) == GEN
    for step, (g, want) in enumerate(zip(got, served["ref_logits"])):
        assert g.shape == (B, served["jc"].vocab)
        np.testing.assert_allclose(to_numpy(g), want, rtol=0,
                                   atol=LOGIT_ATOL, err_msg=f"token {step}")


def test_served_chips_match(served):
    """The seven projections of every layer on its chip: plan and index
    maps exact, tiles equal, calibrated tensors to f32 rounding."""
    lay = served["res"].params["layers"]
    ref = served["ref_deployed"]["layers"]
    names = [n for n in tnn.PACKED_PROJ_KEYS if n + "_cim" in lay]
    assert names == ["wq", "wk", "wv", "wo", "w_g", "w_i", "w_o"]
    assert sorted(k for k in lay if k.endswith("_cim")) == \
        sorted(k for k in ref if k.endswith("_cim"))
    for n in names:
        for li, pcl in enumerate(lay[n + "_cim"]):
            pj = jax.tree_util.tree_map(lambda a: np.asarray(a)[li, 0],
                                        ref[n + "_cim"].shards)
            assert_chip_match(pcl, pj, f"{n} layer {li}")


def test_biases_cross_attention_and_encoder_stay_float(served):
    """Only the decoder's packed projections go on chips: the QKV biases,
    the cross-attention and the encoder stack stay float tensors, as the
    reference keeps them."""
    p = served["res"].params
    lay = p["layers"]
    jc = served["jc"]
    want = {"bq", "bk", "bv"} if jc.qkv_bias else set()
    if jc.enc_layers:
        want |= {"xln", "xwq", "xwk", "xwv", "xwo"}
        assert not any(k.endswith("_cim") for k in p["enc_layers"])
        assert all(isinstance(v, torch.Tensor)
                   for v in p["enc_layers"].values())
    assert {k for k in FLOAT_KEYS if k in lay} == want
    for k in want:
        assert isinstance(lay[k], torch.Tensor)
        assert k + "_cim" not in lay


def test_served_routes(served):
    """seamless-m4t-medium's merged chip serves through the scheduled
    kernel; the others stay single-pass (the packed kernel)."""
    lay = served["res"].params["layers"]
    routes = {lay[n + "_cim"][0].packed.route() for n in tnn.PACKED_PROJ_KEYS
              if n + "_cim" in lay}
    if served["arch"] == "seamless-m4t-medium":
        assert "cim_mvm_scheduled" in routes
    else:
        assert routes == {"cim_mvm_packed"}


def test_served_launches_no_kernel_on_cpu(served):
    assert served["launches"] == 0


def test_chip_meter_matches_reference(served):
    tc = served["res"].cfg
    want = JChipMeter.from_params(served["ref_deployed"], tc.cim_in_bits,
                                  tc.cim_out_bits)
    got = ChipMeter.from_params(served["res"].params, tc.cim_in_bits,
                                tc.cim_out_bits)
    strip = lambda m: {k: (e.rows, e.cols, e.n_stack)
                       for k, e in m.entries.items()}
    assert strip(got) == strip(want)
    assert len(got.entries) == 7


@pytest.fixture(scope="module")
def qwen2_chips():
    """qwen2-72b's smoke chips deployed by the port alone, from its own
    seeded params with seeded nonzero QKV biases: (cfg, params)."""
    tc = tserve.serving_config("qwen2-72b", smoke=True, cim=True)
    params = tT.init_params(tc, seed=0, device="cpu")
    gen = torch.Generator().manual_seed(11)
    params["layers"].update({n: 0.5 * torch.randn(
        params["layers"][n].shape, generator=gen) for n in ("bq", "bk",
                                                            "bv")})
    tc, tp, _ = tserve.deploy("qwen2-72b", smoke=True, cim=True,
                              device="cpu", params=params)
    return tc, tp


def test_pool_tokens_equal_alone(qwen2_chips):
    """qwen2-72b's chips behind the port's engine (plain versions on the
    CPU; prompts of one and two chunks): each request's tokens equal the
    request served alone on the static path, logits within LOGIT_ATOL."""
    tc, tp = qwen2_chips
    rng = np.random.default_rng(5)
    reqs = [S.Request(rid=i, prompt=rng.integers(0, tc.vocab, (n,))
                      .astype(np.int32), max_new=g)
            for i, (n, g) in enumerate(zip([16, 32, 16], [4, 6, 3]))]
    eng = S.ContinuousBatchingEngine(tc, tp, n_slots=2, max_len=40,
                                     chunk=16, capture_logits=True)
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


def test_decode_rows_do_not_depend_on_the_batch(qwen2_chips):
    """A decode step over 4 rows writes each row's keys and values as that
    row stepped alone does, bit for bit, in every layer: RMSNorm's and
    attention's sums, which feed the chips, run in float64
    (`models/transformer.py`). The logits then pass the float32
    unembedding, whose summation order does depend on the rows: within
    UNEMBED_ATOL. (At these smoke widths float32 sums happen to agree on
    the CPU too; tests/test_torch_archs.py holds the sums at qwen2-72b's
    widths, where they do not.)"""
    tc, tp = qwen2_chips
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, tc.vocab, (4, 10)))
    cache = tT.init_cache(tc, 4, 16, device="cpu")
    _, cache = tT.prefill(tp, toks[:, :9], cache, tc)
    rows = [{k: (v if k == "len" else v[:, i:i + 1].clone())
             for k, v in cache.items()} for i in range(4)]
    lg, cache = tT.decode_step(tp, cache, toks[:, 9:], tc)
    for i, row in enumerate(rows):
        lg_i, row = tT.decode_step(tp, row, toks[i:i + 1, 9:], tc)
        for k in ("k", "v"):
            assert torch.equal(row[k][:, 0], cache[k][:, i]), (i, k)
        np.testing.assert_allclose(to_numpy(lg_i[0]), to_numpy(lg[i]),
                                   rtol=0, atol=UNEMBED_ATOL)

"""Port parity, the dense, VLM and encoder-decoder archs on the float path
(`repro_torch/models/transformer.py`: QKV bias, MQA, the vision prefix,
the encoder and cross-attention, the chunked online-softmax attention;
the configs; the serving driver's entry points): the JAX reference and
the port on the CPU, from the same numpy inputs and params, at the SMOKE
configs of qwen2-72b, codeqwen1.5-7b, granite-20b, internvl2-1b and
seamless-m4t-medium.

The reference initialises the QKV biases to zero, so every test that
runs a qwen-family or internvl2 model first overwrites bq, bk and bv with
seeded nonzero values (`with_biases`), in both packages.

Tolerances: the whole model teacher-forced (`lm_forward`) within
FLOAT_ATOL = 1e-5: smoke logits are O(0.1-1) after O(100) f32 roundings
taken in another order (2^-24 * 100 ~ 6e-6). Attention's chunked path
against the dense one and against the reference's chunked path within
ATTN_ATOL = 2e-5, the reference's own bound (tests/test_transformer.py),
with ATTN_CHUNK patched to 16 in each package; at the real ATTN_CHUNK
against the dense formula in float64.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import frontend_inputs, to_numpy, to_torch, with_biases

from repro import configs as jconfigs
from repro.models import transformer as jT
from repro_torch import configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve as tserve
from repro_torch.launch import steps as tsteps
from repro_torch.models import transformer as tT

FLOAT_ATOL = 1e-5
ATTN_ATOL = 2e-5
ARCHS = ("qwen2-72b", "codeqwen1.5-7b", "granite-20b", "internvl2-1b",
         "seamless-m4t-medium")
def test_configs_accept_every_reference_arch():
    """The registry knows the reference's ten names, and each config's
    fields equal the reference's (full and smoke)."""
    assert tconfigs.ARCH_NAMES == jconfigs.ARCH_NAMES
    names = ({f.name for f in dataclasses.fields(tT.ArchConfig)}
             & {f.name for f in dataclasses.fields(jT.ArchConfig)}) \
        - {"dtype"}
    for arch in jconfigs.ARCH_NAMES:
        for smoke in (False, True):
            want = jconfigs.get(arch, smoke=smoke)
            got = tconfigs.get(arch, smoke=smoke)
            for n in names:
                assert getattr(got, n) == getattr(want, n), (arch, smoke, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_layout_matches_reference(arch):
    """The port's random params have the reference's tree and shapes: the
    QKV biases, the decoder's cross-attention, the encoder stack and its
    norm, the VLM's vis_proj."""
    jc = jconfigs.get(arch, smoke=True).replace(dtype=jnp.float32)
    tc = tconfigs.get(arch, smoke=True).replace(dtype=torch.float32)
    want = jax.tree_util.tree_map(
        lambda a: tuple(a.shape),
        jax.eval_shape(lambda: jT.init_params(jax.random.PRNGKey(0), jc)))
    got = tT.init_params(tc, seed=0, device="cpu")
    shapes = {k: ({kk: tuple(vv.shape) for kk, vv in v.items()}
                  if isinstance(v, dict) else tuple(v.shape))
              for k, v in got.items()}
    assert shapes == want


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_carries_new_keys(arch):
    """bq bk bv, xln xw*, enc_layers, ln_enc and vis_proj cross from the
    reference exactly, in its layout."""
    jc = jconfigs.get(arch, smoke=True).replace(dtype=jnp.float32)
    pnp = jax.tree_util.tree_map(
        np.asarray, with_biases(jT.init_params(jax.random.PRNGKey(4), jc)))
    got = params_from_numpy(pnp)
    keys = {"bq", "bk", "bv"} if jc.qkv_bias else set()
    if jc.enc_layers:
        keys |= {"xln", "xwq", "xwk", "xwv", "xwo"}
        assert set(got["enc_layers"]) == set(pnp["enc_layers"])
        for k, v in pnp["enc_layers"].items():
            np.testing.assert_array_equal(to_numpy(got["enc_layers"][k]), v)
        np.testing.assert_array_equal(to_numpy(got["ln_enc"]),
                                      pnp["ln_enc"])
    if jc.vis_patches:
        np.testing.assert_array_equal(to_numpy(got["vis_proj"]),
                                      pnp["vis_proj"])
    assert keys <= set(got["layers"])
    for k in keys:
        np.testing.assert_array_equal(to_numpy(got["layers"][k]),
                                      pnp["layers"][k])
    if jc.qkv_bias:
        assert np.abs(pnp["layers"]["bq"]).min() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_float_matches_reference(arch):
    """The whole model teacher-forced on the float path (cim_mode off):
    nonzero QKV biases, the vision prefix ahead of the tokens (its logits
    dropped), the encoder's memory cross-attended by every block."""
    jc = jconfigs.get(arch, smoke=True).replace(dtype=jnp.float32)
    params = with_biases(jT.init_params(jax.random.PRNGKey(2), jc))
    tokens = np.random.default_rng(0).integers(0, jc.vocab, (2, 12))
    extra = frontend_inputs(jc, 2, 10)
    want = np.asarray(jax.jit(lambda p, t, e: jT.lm_forward(p, t, jc, **e))(
        params, jnp.asarray(tokens, jnp.int32),
        {k: jnp.asarray(v) for k, v in extra.items()}))
    tcfg = tserve.serving_config(arch, smoke=True)
    got = tT.lm_forward(
        params_from_numpy(jax.tree_util.tree_map(np.asarray, params)),
        to_torch(tokens).long(), tcfg,
        **{k: to_torch(v) for k, v in extra.items()})
    assert got.shape == (2, 12, jc.vocab)
    np.testing.assert_allclose(to_numpy(got), want, rtol=0, atol=FLOAT_ATOL)


@pytest.mark.parametrize("arch", ["internvl2-1b", "seamless-m4t-medium"])
def test_prefill_decode_float_matches_reference(arch):
    """The serving steps on the float path: the reference's
    make_prefill_step (the vision prefix through `_prefix_embeds`, or the
    encoder over src_embeds) and two decode steps (with the memory), the
    cache sized as its driver sizes it."""
    from repro.launch import steps as jsteps
    jc = jconfigs.get(arch, smoke=True).replace(dtype=jnp.float32)
    params = with_biases(jT.init_params(jax.random.PRNGKey(5), jc))
    tokens = np.random.default_rng(1).integers(0, jc.vocab, (2, 6))
    extra = frontend_inputs(jc, 2, 6)
    max_len = 6 + 3 + jc.vis_patches
    jb = {k: jnp.asarray(v) for k, v in extra.items()}
    logits, cache = jax.jit(jsteps.make_prefill_step(jc))(
        params, jT.init_cache(jc, 2, max_len),
        dict(jb, tokens=jnp.asarray(tokens, jnp.int32)))
    memory = jT._encode(params, jb["src_embeds"], jc) \
        if jc.enc_layers else None
    want = [np.asarray(logits)]
    decode = jax.jit(jsteps.make_decode_step(jc))
    for t in (3, 7):
        batch = {"tokens": jnp.full((2, 1), t, jnp.int32)}
        if memory is not None:
            batch["memory"] = memory
        logits, cache = decode(params, cache, batch)
        want.append(np.asarray(logits))
    assert int(cache["len"]) == 6 + 2 + jc.vis_patches

    tc = tserve.serving_config(arch, smoke=True)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, params))
    tb = {k: to_torch(v) for k, v in extra.items()}
    tcache = tT.init_cache(tc, 2, max_len, device="cpu")
    lg, tcache = tsteps.make_prefill_step(tc)(
        tp, tcache, dict(tb, tokens=to_torch(tokens).long()))
    got = [lg]
    tmem = tT._encode(tp, tb["src_embeds"], tc) if tc.enc_layers else None
    for t in (3, 7):
        lg, tcache = tsteps.make_decode_step(tc)(
            tp, tcache, {"tokens": torch.full((2, 1), t), "memory": tmem})
        got.append(lg)
    assert tcache["len"] == 6 + 2 + tc.vis_patches
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(to_numpy(g), w, rtol=0, atol=FLOAT_ATOL,
                                   err_msg=f"step {step}")


ATTN_CASES = {
    # name: (heads, kv heads, window, softcap, causal)
    "gqa-window-softcap": (4, 2, 20, 50.0, True),
    "mqa": (8, 1, 0, 0.0, True),
    "mha-bidirectional": (4, 4, 0, 0.0, False),
    "gqa-window": (6, 2, 9, 0.0, True),
}


def _attn_inputs(h, hkv, sq=48, sk=48, b=2, d=32, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(sh).astype(np.float32)
            for sh in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d))]


def _both(q, k, v, chunk=None, **kw):
    """(reference, port) attention on the same numpy inputs; `chunk`
    patches ATTN_CHUNK in both packages."""
    jkw = {k_: (jnp.asarray(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    tkw = {k_: (to_torch(v_) if isinstance(v_, np.ndarray) else v_)
           for k_, v_ in kw.items()}
    old = (jT.ATTN_CHUNK, tT.ATTN_CHUNK)
    try:
        if chunk:
            jT.ATTN_CHUNK = tT.ATTN_CHUNK = chunk
        want = jT.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            **jkw)
        got = tT.attention(to_torch(q), to_torch(k), to_torch(v), **tkw)
    finally:
        jT.ATTN_CHUNK, tT.ATTN_CHUNK = old
    return np.asarray(want), to_numpy(got)


@pytest.mark.parametrize("case", ATTN_CASES)
def test_chunked_attention_matches_dense_and_reference(case):
    """ATTN_CHUNK 16 over 48 keys (three chunks): the port's chunked path
    against its dense path and against the reference's chunked path."""
    h, hkv, window, softcap, causal = ATTN_CASES[case]
    q, k, v = _attn_inputs(h, hkv)
    pos = np.arange(48)
    kw = dict(causal=causal, q_pos=pos, kv_pos=pos, window=window,
              softcap=softcap)
    ref_chunked, chunked = _both(q, k, v, chunk=16, **kw)
    _, dense = _both(q, k, v, **kw)
    np.testing.assert_allclose(chunked, dense, rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(chunked, ref_chunked, rtol=0, atol=ATTN_ATOL)


@pytest.mark.parametrize("window", [0, 5])
def test_chunked_attention_per_slot_fill(window):
    """The slot pool's decode shape: one query per row at its own position
    and a (B,) kv_len, MQA, through three chunks of 16 keys."""
    q, k, v = _attn_inputs(8, 1, sq=1, b=3, seed=1)
    kv_len = np.array([40, 17, 48])
    kw = dict(causal=True, q_pos=(kv_len - 1)[:, None], kv_pos=np.arange(48),
              window=window, kv_len=kv_len)
    ref_chunked, chunked = _both(q, k, v, chunk=16, **kw)
    _, dense = _both(q, k, v, **kw)
    np.testing.assert_allclose(chunked, dense, rtol=0, atol=ATTN_ATOL)
    np.testing.assert_allclose(chunked, ref_chunked, rtol=0, atol=ATTN_ATOL)


def test_attention_above_8192_keys_runs_chunked():
    """At the real ATTN_CHUNK a KV of 3 * 4096 keys takes the chunked path
    (the port raised here before it was ported) and matches the dense
    formula computed in float64."""
    sk = 3 * tT.ATTN_CHUNK
    q, k, v = (torch.from_numpy(a) for a in
               _attn_inputs(2, 1, sq=2, sk=sk, b=1, d=8, seed=2))
    pos = torch.arange(sk)
    got = tT.attention(q, k, v, causal=True, q_pos=pos[-2:], kv_pos=pos,
                       window=6000)
    q64, k64, v64 = q.double(), k.double().expand(-1, -1, 2, -1), \
        v.double().expand(-1, -1, 2, -1)
    logits = torch.einsum("bqhd,bkhd->bhqk", q64, k64) / 8 ** 0.5
    dist = pos[-2:, None] - pos[None, :]
    logits = logits.masked_fill(~((dist >= 0) & (dist < 6000)), -torch.inf)
    want = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v64)
    np.testing.assert_allclose(to_numpy(got), to_numpy(want), rtol=0,
                               atol=ATTN_ATOL)


def test_norm_and_attention_rows_do_not_depend_on_the_batch():
    """RMSNorm and attention at qwen2-72b's widths (d 8192; one query, 64
    heads / 8 KV of 128, over 96 keys): each row of a batch of 4 equals
    the row computed alone, bit for bit — their sums feed chip inputs, and
    run in float64 (`transformer._dot`, `rms_norm`). Summed in float32,
    most of the scores move here on the CPU, as on the card."""
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((4, 1, 8192)).astype(np.float32))
    scale = torch.from_numpy(rng.standard_normal(8192).astype(np.float32))
    norm = tT.rms_norm(x, scale)
    q, k, v = (torch.from_numpy(a) for a in
               _attn_inputs(64, 8, sq=1, sk=96, b=4, d=128, seed=3))
    kv_len = torch.tensor([96, 40, 7, 61])
    attn = tT.attention(q, k, v, causal=True, q_pos=(kv_len - 1)[:, None],
                        kv_pos=torch.arange(96), kv_len=kv_len)
    for i in range(4):
        assert torch.equal(tT.rms_norm(x[i:i + 1], scale)[0], norm[i])
        alone = tT.attention(q[i:i + 1], k[i:i + 1], v[i:i + 1], causal=True,
                             q_pos=(kv_len[i:i + 1] - 1)[:, None],
                             kv_pos=torch.arange(96), kv_len=kv_len[i:i + 1])
        assert torch.equal(alone[0], attn[i]), i


def test_chunked_attention_rejects_ragged_kv():
    q, k, v = (torch.from_numpy(a) for a in _attn_inputs(2, 1, sk=50))
    pos = torch.arange(50)
    old = tT.ATTN_CHUNK
    try:
        tT.ATTN_CHUNK = 16
        with pytest.raises(ValueError, match="multiple of ATTN_CHUNK"):
            tT.attention(q, k, v, causal=True, q_pos=pos[:48], kv_pos=pos)
    finally:
        tT.ATTN_CHUNK = old


def test_serve_cli_codeqwen_smoke():
    """The port's counterpart of the reference's serve smoke test
    (tests/test_system.py::test_serve_driver_smoke): codeqwen1.5-7b on
    the float path."""
    out = tserve.main(["--arch", "codeqwen1.5-7b", "--smoke", "--batch", "2",
                       "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert tuple(out.shape) == (2, 4)
    assert int(out.min()) >= 0


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_cim_each_arch(arch, capsys):
    """`serve --smoke --cim` serves every new arch: seven projection
    stacks compiled, tokens of the requested shape."""
    out = tserve.main(["--arch", arch, "--smoke", "--cim", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert tuple(out.shape) == (2, 3)
    assert "compiled 7 projection stacks x 2 layers" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["qwen2-72b", "codeqwen1.5-7b",
                                  "granite-20b"])
def test_serve_cli_traffic_decoder_only(arch):
    stats = tserve.main(["--arch", arch, "--smoke", "--cim", "--device",
                         "cpu", "--traffic", "--requests", "3", "--slots",
                         "2", "--gen", "4"])
    assert stats["decode_traces"] == 1
    assert stats["requests"] == 3


@pytest.mark.parametrize("arch", ["internvl2-1b", "seamless-m4t-medium"])
def test_serve_traffic_refuses_prefix_archs(arch):
    """As the reference's driver: no slot pool for encoder-decoder memory
    or a vision prefix."""
    with pytest.raises(SystemExit, match="decoder-only archs"):
        tserve.serve_traffic(arch, smoke=True, cim=True, device="cpu")
    with pytest.raises(SystemExit, match="decoder-only archs"):
        tserve.main(["--arch", arch, "--smoke", "--device", "cpu",
                     "--traffic"])


def test_static_serve_sizes_cache_for_the_vision_prefix():
    """The static driver leaves room for the vision prefix, as the
    reference does (cache prompt + gen + vis_patches) though it runs none;
    with vis_prefix the prefix runs ahead of the prompt."""
    kw = dict(smoke=True, batch=2, prompt_len=5, gen=3, device="cpu")
    plain = tserve.serve_static("internvl2-1b", **kw)
    pre = tserve.serve_static("internvl2-1b", vis_prefix=True, **kw)
    assert plain.vis_embeds is None
    assert tuple(pre.vis_embeds.shape) == (2, 16, 112)
    assert tuple(pre.out.tokens.shape) == (2, 3)
    assert not torch.equal(pre.out.logits[0], plain.out.logits[0])

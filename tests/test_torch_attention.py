"""The GQA attention kernel (`kernels/attention`) and its dispatch from
`models/transformer.attention`.

Here, on the CPU: CPU tensors keep the plain path, with or without grad,
and launch nothing; the plain path's bits are those of the dense formula
as it stood; the kernel's backward is the plain path's gradient; the kernel's key ranges are exactly
the plain mask's unmasked keys; its routes at the cells' shapes.

On the card (`cuda`, skipped here; run there with
    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_attention.py):
one DMMA against the kernel's CUDA-core emulation of it, bit for bit; the
kernel against the plain path at the cells' shapes and the other archs'
(ATTN_TOL); a row alone against the row in a batch of 16, a prompt
chunked against it whole, both routes and both value-pass modes, a graph
replay against the eager call, a differentiable call's output and
gradients against the plain path's, all bit for bit; launches counted;
other dtypes and head dims refused.
"""
import math
import random

import pytest
import torch

from repro_torch.kernels.attention import kernel as AK
from repro_torch.kernels.build import LAUNCHES
from repro_torch.models import transformer as T

# |kernel - plain| over sum_k p_k |v_k| (the plain path's with |v|): the
# two sum a row's exps in another order (f32, a few ulps of p); bf16 then
# rounds p and the output to 8 bits, where one ulp of a p can flip
ATTN_TOL = {torch.float32: 2.0 ** -19, torch.bfloat16: 2.0 ** -7}
# the share of f32 outputs that may differ from the plain path's at all:
# a float64 sum rounds to another f32 in another order only at a tie
# (about 2^-29 of sums; a moved score moves its row's D outputs)
EXACT_SHARE = 1e-3


def _old_dense(q, k, v, *, causal, q_pos, kv_pos, window=0, softcap=0.0,
               kv_len=None):
    """The dense attention formula as it stood before the kernel."""
    rep = q.shape[2] // k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[-1])
    kf = torch.repeat_interleave(k, rep, dim=2)
    vf = torch.repeat_interleave(v, rep, dim=2)
    logits = T._dot("bqhd,bkhd->bhqk", q, kf) * scale
    logits = T._softcap(logits, softcap)
    mask = T._attn_mask(q_pos, kv_pos, causal, window, kv_len)
    logits = torch.where(T._expand_mask(mask), logits.to(torch.float32),
                         -1e30)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return T._dot("bhqk,bkhd->bqhd", probs, v if rep == 1 else vf)


def _inputs(b, sq, h, hkv, d, sk, fills, *, dtype=torch.float32,
            device="cpu", seed=0):
    """q, k, v, kv_len (B,) int32 and q_pos (B, Sq) of rows that end at
    their slot's fill."""
    gen = torch.Generator(device).manual_seed(seed)
    q, k, v = (torch.randn(sh, generator=gen, device=device).to(dtype)
               for sh in ((b, sq, h, d), (b, sk, hkv, d), (b, sk, hkv, d)))
    kv_len = torch.tensor(fills, dtype=torch.int32, device=device)
    q_pos = (kv_len - sq).long()[:, None] + torch.arange(sq, device=device)
    return q, k, v, kv_len, q_pos


@pytest.mark.parametrize("case", [
    dict(h=8, hkv=2, causal=True, window=0, softcap=0.0),
    dict(h=4, hkv=4, causal=True, window=5, softcap=50.0),
    dict(h=6, hkv=1, causal=False, window=0, softcap=0.0),
])
def test_cpu_takes_the_plain_path_unchanged(case):
    """On CPU tensors `attention` runs the plain path, bit for bit the
    formula as it stood, and launches nothing."""
    q, k, v, kv_len, q_pos = _inputs(3, 4, case["h"], case["hkv"], 16, 24,
                                     [24, 9, 5])
    kw = dict(causal=case["causal"], q_pos=q_pos,
              kv_pos=torch.arange(24), window=case["window"],
              softcap=case["softcap"], kv_len=kv_len)
    before = dict(LAUNCHES)
    got = T.attention(q, k, v, **kw)
    assert torch.equal(got, _old_dense(q, k, v, **kw))
    assert LAUNCHES == before


def test_dispatch_rules(monkeypatch):
    """CPU tensors never reach the kernel, with or without grad; above
    2 * ATTN_CHUNK keys the chunked path takes the call."""
    def refuse(*args):
        raise AssertionError("the kernel took a CPU call")
    monkeypatch.setattr(T._KernelAttention, "apply", refuse)
    q, k, v, kv_len, q_pos = _inputs(2, 3, 4, 2, 8, 6, [6, 4])
    kw = dict(causal=True, q_pos=q_pos, kv_pos=torch.arange(6),
              kv_len=kv_len)
    T.attention(q, k, v, **kw)
    T.attention(q.requires_grad_(True), k, v, **kw)
    monkeypatch.setattr(T, "ATTN_CHUNK", 2)
    monkeypatch.setattr(T, "_chunked_attention",
                        lambda *a, **kw: "chunked")
    assert T.attention(q, k, v, **kw) == "chunked"


@pytest.mark.parametrize("needs", ["q", "k", "v", "qkv"])
def test_kernel_backward_is_the_plain_gradient(monkeypatch, needs):
    """`_KernelAttention`'s backward recomputes the plain path: with the
    kernel's forward stood in by the plain formula, its output and the
    gradients of the inputs that need them equal autograd's through the
    plain path, bit for bit, and the others get none."""
    def plain_kernel(q, k, v, *, causal, q_pos, window, softcap, kv_len):
        return _old_dense(q, k, v, causal=causal, q_pos=q_pos,
                          kv_pos=torch.arange(k.shape[1]), window=window,
                          softcap=softcap, kv_len=kv_len)
    monkeypatch.setattr(AK, "gqa_attention", plain_kernel)
    q, k, v, kv_len, q_pos = _inputs(2, 3, 8, 2, 16, 10, [10, 7])
    kw = dict(causal=True, q_pos=q_pos, kv_pos=torch.arange(10), window=4,
              softcap=30.0, kv_len=kv_len)
    grad = torch.randn(q.shape, generator=torch.Generator().manual_seed(9))
    ins = [t.clone().requires_grad_(n in needs)
           for t, n in zip((q, k, v), "qkv")]
    refs = [t.clone().requires_grad_(n in needs)
            for t, n in zip((q, k, v), "qkv")]
    got = T._KernelAttention.apply(*ins, kw)
    want = _old_dense(*refs, **kw)
    assert torch.equal(got, want)
    got.backward(grad)
    want.backward(grad)
    for a, b in zip(ins, refs):
        assert (a.grad is None) == (b.grad is None)
        if b.grad is not None:
            assert torch.equal(a.grad, b.grad)


def test_grad_inputs_keep_the_plain_path():
    """A differentiable call (LM training) runs the plain path and its
    gradient flows; nothing launches."""
    q, k, v, kv_len, q_pos = _inputs(2, 3, 4, 2, 8, 6, [6, 4])
    q.requires_grad_(True)
    before = dict(LAUNCHES)
    out = T.attention(q, k, v, causal=True, q_pos=q_pos,
                      kv_pos=torch.arange(6), kv_len=kv_len)
    out.sum().backward()
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    assert LAUNCHES == before


def test_kernel_refuses_cpu_tensors():
    q, k, v, kv_len, q_pos = _inputs(1, 1, 2, 1, 8, 4, [4])
    with pytest.raises(ValueError, match="CUDA"):
        AK.gqa_attention(q, k, v, causal=True, q_pos=q_pos, kv_len=kv_len)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [0, 3, 40])
@pytest.mark.parametrize("fill", ["tensor", "int", "none"])
def test_row_ranges_are_the_unmasked_keys(causal, window, fill):
    """Each row's [lo, hi) is exactly the set of keys the plain mask
    leaves, and [0, Sk) where it leaves none (every key -1e30)."""
    sk, sq = 37, 5
    fills = torch.tensor([37, 12, 0, 3])
    q_pos = torch.stack([torch.arange(sq) + o for o in (32, 7, -2, 10)])
    kv_len = {"tensor": fills, "int": 20, "none": None}[fill]
    lo, hi = AK.row_ranges(q_pos, sk, causal=causal, window=window,
                           kv_len=kv_len)
    mask = T._attn_mask(q_pos, torch.arange(sk), causal, window,
                        kv_len if fill != "tensor" else fills)
    if mask.ndim == 2:
        mask = mask.expand(4, sq, sk)
    keys = torch.arange(sk)
    for bi in range(4):
        for s in range(sq):
            want = mask[bi, s]
            if not bool(want.any()):
                assert (lo[bi, s], hi[bi, s]) == (0, sk)
            else:
                got = (keys >= lo[bi, s]) & (keys < hi[bi, s])
                assert torch.equal(got, want), (bi, s)


def test_routes_at_the_cells_shapes():
    """granite's decode (48 rows a KV head) and chunk (12288) on DMMA, the
    decode per split, the chunk's splits summed in the block; deepseek's
    decode (1 row) on the CUDA cores; its chunk (256 rows, 16 heads) and
    qwen2's decode (16 slots x 8 KV heads of 8 rows) summed in the block;
    head dims pad up to 32, 64, 128 or 256."""
    assert AK.mma_route(48) and not AK.whole_splits(16, 48)
    assert AK.mma_route(48 * 256) and AK.whole_splits(1, 48 * 256)
    assert not AK.mma_route(1) and not AK.whole_splits(16 * 16, 1)
    assert AK.mma_route(256) and AK.whole_splits(16, 256)
    assert AK.mma_route(8) and AK.whole_splits(16 * 8, 8)
    assert not AK.mma_route(AK.MMA_ROWS - 1) and AK.mma_route(AK.MMA_ROWS)
    assert [AK.padded_head_dim(d) for d in (16, 32, 64, 112, 128, 256)] \
        == [32, 32, 64, 128, 128, 256]
    with pytest.raises(ValueError):
        AK.padded_head_dim(512)


@pytest.mark.parametrize("sk,order", [
    (4096, (1024, 4, 1024)), (8192, (1024, 8, 1024)),
    (3000, (1024, 3, 1024)), (1025, (1024, 2, 1024)), (1024, (32, 32, 32)),
    (96, (32, 4, 32)), (33, (32, 2, 32)), (5, (8, 1, 32)), (1, (1, 1, 32)),
])
def test_softmax_order(sk, order):
    """The order of PyTorch's CUDA softmax sum over sk f32 entries: one
    warp a row up to 1024 (the persistent kernel), then a block of 1024
    threads; every entry summed once."""
    stride, reg, nth = AK.softmax_order(sk)
    assert (stride, reg, nth) == order
    assert stride * reg >= sk
    assert sk <= 1024 or stride * (reg - 1) < sk


# ------------------------------------------------------------- on the card

def _card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    return torch.device("cuda")


def _check_close(got, q, k, v, kv_len, q_pos, what, *, causal=True,
                 window=0, softcap=0.0):
    kw = dict(causal=causal, q_pos=q_pos,
              kv_pos=torch.arange(k.shape[1], device=k.device),
              window=window, softcap=softcap, kv_len=kv_len)
    want = T._dense_attention(q, k, v, **kw).float()
    mag = T._dense_attention(q, k, v.abs(), **kw).float()
    err = ((got.float() - want).abs() - ATTN_TOL[q.dtype] * mag).max()
    assert float(err) <= 0, (what, float(err))
    sk = k.shape[1]
    if q.dtype == torch.float32 and (sk <= 1024 or sk >= 2500):
        # p is the plain path's to the bit where the softmax sums in
        # PyTorch's order (`softmax_order`): only float64 rounding ties
        # in the dot products are left
        moved = float((got.float() != want).float().mean())
        assert moved <= EXACT_SHARE, (what, moved)


@pytest.mark.cuda
def test_dmma_matches_its_cuda_core_emulation_on_card():
    """One m16n8k4 DMMA equals `fma4` (four fused multiply-adds in k order)
    on operands spanning 2^-40 .. 2^40, where the order of the sums shows."""
    dev = _card()
    gen = torch.Generator(dev).manual_seed(5)
    f64 = torch.float64
    for _ in range(20):
        a, b, c = (torch.randn(sh, generator=gen, device=dev, dtype=f64)
                   * torch.exp2(torch.randint(-40, 40, sh, generator=gen,
                                              device=dev).to(f64))
                   for sh in ((16, 4), (4, 8), (16, 8)))
        dm, e = AK.dmma_probe(a, b, c)
        assert torch.equal(dm, e)


CASES = {
    # name: (B, Sq, H, Hkv, D, Sk, fills, window, softcap, causal)
    "granite decode": (16, 1, 48, 1, 128, 4096, "ragged", 0, 0.0, True),
    "granite chunk at 0": (1, 256, 48, 1, 128, 4096, [256], 0, 0.0, True),
    "granite chunk at 1000": (1, 256, 48, 1, 128, 4096, [1256], 0, 0.0,
                              True),
    "granite chunk at 3840": (1, 256, 48, 1, 128, 4096, [4096], 0, 0.0,
                              True),
    "deepseek decode": (16, 1, 16, 16, 128, 4096, "ragged", 0, 0.0, True),
    "deepseek chunk": (1, 256, 16, 16, 128, 4096, [2304], 0, 0.0, True),
    "qwen2 decode": (4, 1, 64, 8, 128, 2048, "ragged", 0, 0.0, True),
    "gemma2 local": (2, 16, 16, 8, 256, 8192, [8000, 4500], 4096, 50.0,
                     True),
    "gemma2 global decode": (4, 1, 16, 8, 256, 8192, "ragged", 0, 50.0,
                             True),
    "zamba2 shared block": (2, 8, 32, 32, 112, 512, [512, 100], 0, 0.0,
                            True),
    "internvl2 rep 7": (3, 1, 14, 2, 64, 600, "ragged", 0, 0.0, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_matches_plain_on_card(name, dtype):
    """The kernel against the plain path on the card (ATTN_TOL); each call
    adds one launch, and `attention` dispatches to it."""
    dev = _card()
    b, sq, h, hkv, d, sk, fills, window, cap, causal = CASES[name]
    if fills == "ragged":
        rng = random.Random(len(name))
        fills = [rng.randint(1, sk) for _ in range(b)]
    q, k, v, kv_len, q_pos = _inputs(b, sq, h, hkv, d, sk, fills,
                                     dtype=dtype, device=dev)
    before = LAUNCHES["gqa_attention"]
    got = T.attention(q, k, v, causal=causal, q_pos=q_pos,
                      kv_pos=torch.arange(sk, device=dev), window=window,
                      softcap=cap, kv_len=kv_len)
    torch.cuda.synchronize()
    assert LAUNCHES["gqa_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    _check_close(got, q, k, v, kv_len, q_pos, name, causal=causal,
                 window=window, softcap=cap)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_attention_matches_plain_on_card(dtype):
    """seamless's encoder: non-causal, no fill, positions 0 .. S - 1."""
    dev = _card()
    q, k, v, _, _ = _inputs(2, 300, 16, 16, 64, 300, [300, 300],
                            dtype=dtype, device=dev)
    pos = torch.arange(300, device=dev)
    got = T.attention(q, k, v, causal=False, q_pos=pos, kv_pos=pos)
    _check_close(got, q, k, v, None, pos, "encoder", causal=False)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["granite", "deepseek"])
def test_rows_alone_equal_rows_in_a_pool_on_card(shape):
    """Each slot's rows computed alone equal them in a pool of 16, bit for
    bit, on both routes and both value-pass modes (which also equal each
    other)."""
    dev = _card()
    h, hkv = (48, 1) if shape == "granite" else (16, 16)
    rng = random.Random(3)
    fills = [rng.randint(1, 4096) for _ in range(16)]
    q, k, v, kv_len, q_pos = _inputs(16, 1, h, hkv, 128, 4096, fills,
                                     device=dev, seed=1)
    kw = dict(causal=True, window=0, softcap=0.0)
    runs = [dict(), dict(mma=True, whole=False), dict(mma=True, whole=True),
            dict(mma=False, whole=False)]
    pools = [AK._attention(q, k, v, True, q_pos, 0, 0.0, kv_len, **r)
             for r in runs]
    for p in pools[1:]:
        assert torch.equal(p, pools[0])
    for i in range(16):
        s = slice(i, i + 1)
        alone = AK.gqa_attention(q[s], k[s], v[s], q_pos=q_pos[s],
                                 kv_len=kv_len[s], **kw)
        assert torch.equal(alone, pools[0][s]), i


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["granite", "deepseek"])
def test_chunked_prompt_equals_it_whole_on_card(shape):
    """A 774-token prompt attended in chunks of 256 (the last of 6 rows:
    on the CUDA cores at deepseek's one head a group) equals it attended
    whole, bit for bit, against a 4096-key cache."""
    dev = _card()
    h, hkv = (48, 1) if shape == "granite" else (16, 16)
    n = 774
    q, k, v, _, _ = _inputs(1, n, h, hkv, 128, 4096, [n], device=dev,
                            seed=2)
    kw = dict(causal=True, window=0, softcap=0.0)
    pos = torch.arange(n, device=dev)[None]
    whole = AK.gqa_attention(q, k, v, q_pos=pos,
                             kv_len=torch.tensor([n], device=dev), **kw)
    parts = []
    for c0 in range(0, n, 256):
        c1 = min(n, c0 + 256)
        parts.append(AK.gqa_attention(
            q[:, c0:c1], k, v, q_pos=pos[:, c0:c1],
            kv_len=torch.tensor([c1], device=dev), **kw))
    assert torch.equal(torch.cat(parts, 1), whole)


@pytest.mark.cuda
def test_graph_replay_equals_eager_on_card():
    """The call captured in a CUDA graph (kv_len and q_pos read on the
    device, scratch from the graph's pool) replays to the eager result,
    also after the fills change in place."""
    dev = _card()
    rng = random.Random(4)
    fills = [rng.randint(1, 4096) for _ in range(16)]
    q, k, v, kv_len, q_pos = _inputs(16, 1, 48, 1, 128, 4096, fills,
                                     device=dev, seed=3)
    kw = dict(causal=True, window=0, softcap=0.0)
    call = lambda: AK.gqa_attention(q, k, v, q_pos=q_pos, kv_len=kv_len,
                                    **kw)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    before = LAUNCHES["gqa_attention"]
    with torch.cuda.graph(graph):
        static = call()
    assert LAUNCHES["gqa_attention"] == before + 1
    for step in range(2):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(static, call()), step
        kv_len.add_(1).clamp_(max=4096)
        q_pos.copy_((kv_len - 1).long()[:, None])


@pytest.mark.cuda
def test_kernel_refuses_other_dtypes_and_head_dims_on_card():
    dev = _card()
    for dtype in (torch.float16, torch.float64):
        q, k, v, kv_len, q_pos = _inputs(1, 1, 4, 2, 64, 32, [32],
                                         dtype=dtype, device=dev)
        with pytest.raises(TypeError):
            AK.gqa_attention(q, k, v, causal=True, q_pos=q_pos,
                             kv_len=kv_len)
    q, k, v, kv_len, q_pos = _inputs(1, 1, 2, 1, 320, 32, [32], device=dev)
    with pytest.raises(ValueError):
        AK.gqa_attention(q, k, v, causal=True, q_pos=q_pos, kv_len=kv_len)


@pytest.mark.cuda
def test_grad_inputs_take_the_kernel_on_card():
    """On the card a differentiable call (LM training) launches the kernel
    once; its output and its gradients equal the plain path's, bit for
    bit (at 64 keys the kernel's softmax order is PyTorch's; the backward
    is the plain path's own)."""
    dev = _card()
    q, k, v, kv_len, q_pos = _inputs(2, 4, 8, 2, 64, 64, [64, 30],
                                     device=dev)
    grad = torch.randn(q.shape, generator=torch.Generator(dev).manual_seed(9),
                       device=dev)
    kw = dict(causal=True, q_pos=q_pos, kv_pos=torch.arange(64, device=dev),
              kv_len=kv_len)
    ins = [t.clone().requires_grad_(True) for t in (q, k, v)]
    refs = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = LAUNCHES["gqa_attention"]
    got = T.attention(*ins, **kw)
    assert LAUNCHES["gqa_attention"] == before + 1
    want = T._dense_attention(*refs, window=0, softcap=0.0, **kw)
    assert torch.equal(got, want)
    got.backward(grad)
    want.backward(grad)
    for a, b in zip(ins, refs):
        assert torch.equal(a.grad, b.grad)

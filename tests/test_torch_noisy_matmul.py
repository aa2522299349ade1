"""Port parity, the noise-injection training matmul: the port's plain
`noisy_matmul` against the reference's `noisy_matmul_pallas` (interpret
mode) on the same inputs, seeds and blocks; its noise statistics and seed
determinism as the reference's own tests check them; the weight pass's
plain version and the SGEMM's tiling; and, where a CUDA device is
present, the two CUDA kernels (weight pass, SGEMM) against their plain
versions.

Tolerance: both packages draw eps = hash_normal at the same weight-tile
coordinates, so they differ only by f32 reassociation of the K-term dot
and by the few ulps of their logf / cosf:
    |y_port - y_ref| <= (2K + 8) * 2^-24 * (|x| @ (|w| + sigma * |eps|))

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_noisy_matmul.py
"""
import numpy as np
import pytest
import torch

from _torch_parity import to_numpy, to_torch

from repro_torch.kernels.noisy_matmul import kernel as NK
from repro_torch.kernels.noisy_matmul import ops, ref

# (M, K, N, block): the reference tests' two blocks and a padded shape
CASES = [(16, 64, 32, (16, 32, 32)), (64, 128, 64, (64, 64, 64)),
         (50, 300, 70, (32, 128, 32))]


def _inputs(i):
    m, k, n, _ = CASES[i]
    rng = np.random.default_rng(10 + i)
    return (rng.normal(size=(m, k)).astype(np.float32),
            rng.normal(size=(k, n)).astype(np.float32))


def _tolerance(x, w, sigma_frac, seed, block):
    """The module docstring's bound, from the port's eps."""
    k, n = w.shape
    xt, wt = to_torch(x).double(), to_torch(w).double()
    sig = sigma_frac * float(wt.abs().max())
    eps = NK.weight_noise_eps(k, n, seed, min(block[1], k),
                              min(block[2], n)).double()
    return to_numpy((2 * k + 8) * 2.0 ** -24
                    * (xt.abs() @ (wt.abs() + sig * eps.abs())))


@pytest.fixture(scope="module")
def reference():
    """The reference's noisy_matmul at every case, sigma 0.1 and 0."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp
    from repro.kernels.noisy_matmul.ops import noisy_matmul as jnm
    out = {}
    for i, (_, _, _, blk) in enumerate(CASES):
        x, w = _inputs(i)
        for frac in (0.1, 0.0):
            out[i, frac] = np.asarray(jnm(jnp.asarray(x), jnp.asarray(w),
                                          frac, seed=3, block=blk))
    return out


@pytest.mark.parametrize("i", range(len(CASES)))
def test_plain_matches_reference(reference, i):
    x, w = _inputs(i)
    blk = CASES[i][3]
    got = to_numpy(ops.noisy_matmul(to_torch(x), to_torch(w), 0.1, seed=3,
                                    block=blk))
    want = reference[i, 0.1]
    assert np.all(np.abs(got - want) <= _tolerance(x, w, 0.1, 3, blk))
    # the noise moved the product: the comparison is not of x @ w alone
    assert np.abs(want - x @ w).max() > 100 * np.abs(got - want).max()


@pytest.mark.parametrize("i", range(len(CASES)))
def test_zero_noise_is_the_plain_product(reference, i):
    """sigma = 0: x @ w to f32 reassociation, as the reference's."""
    x, w = _inputs(i)
    got = to_numpy(ops.noisy_matmul(to_torch(x), to_torch(w), 0.0,
                                    block=CASES[i][3]))
    tol = (2 * x.shape[1] + 8) * 2.0 ** -24 * (np.abs(x) @ np.abs(w))
    assert np.all(np.abs(got - x @ w) <= tol)
    assert np.all(np.abs(got - reference[i, 0.0]) <= tol)


def test_eps_matches_reference_hash_normal():
    """eps at the reference's tile coordinates: tile (k, j) of a (bk, bn)
    blocking is hash_normal((bk, bn), seed, k, j), to a few ulps."""
    from repro.kernels.prng import hash_normal
    k, n, bk, bn = 100, 70, 32, 64
    eps = to_numpy(NK.weight_noise_eps(k, n, 9, bk, bn))
    for kb in range(-(-k // bk)):
        for jb in range(-(-n // bn)):
            want = np.asarray(hash_normal((bk, bn), 9, kb, jb))
            got = eps[kb * bk:(kb + 1) * bk, jb * bn:(jb + 1) * bn]
            np.testing.assert_allclose(got, want[:got.shape[0],
                                                 :got.shape[1]],
                                       rtol=1e-5, atol=1e-6)


def test_statistics_and_seed():
    """The reference's test: the injected noise's spread is 0.1 * max|w|
    * rms ||x|| within 30%, deterministic in the seed, and another seed
    gives another matrix."""
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(64, 128, generator=gen)
    w = torch.randn(128, 64, generator=gen)
    y = ops.noisy_matmul(x, w, 0.1, seed=3, block=(64, 64, 64))
    d = to_numpy(y - x @ w)
    pred = 0.1 * float(w.abs().max()) * float(
        torch.sqrt(torch.mean(torch.sum(x ** 2, dim=1))))
    assert 0.7 * pred < d.std() < 1.3 * pred
    y2 = ops.noisy_matmul(x, w, 0.1, seed=3, block=(64, 64, 64))
    assert torch.equal(y, y2)
    y3 = ops.noisy_matmul(x, w, 0.1, seed=4, block=(64, 64, 64))
    assert float((y3 - y).abs().max()) > 0


def test_statistical_reference():
    """noisy_matmul_ref draws eps from a generator: at sigma 0 it is the
    plain product; above it the spread matches the kernel's."""
    gen = torch.Generator().manual_seed(1)
    x = torch.randn(64, 128, generator=gen)
    w = torch.randn(128, 64, generator=gen)
    assert torch.allclose(ref.noisy_matmul_ref(x, w, 0.0, gen), x @ w)
    d_ref = (ref.noisy_matmul_ref(x, w, 0.1, gen) - x @ w).std()
    d_ker = (ops.noisy_matmul(x, w, 0.1, seed=5) - x @ w).std()
    assert 0.8 < float(d_ref / d_ker) < 1.25


def test_cpu_runs_plain_without_launching():
    before = dict(NK.LAUNCHES)
    x, w = torch.randn(8, 16), torch.randn(16, 8)
    assert torch.equal(ops.noisy_matmul(x, w, 0.1, seed=2),
                       ops.noisy_matmul(x, w, 0.1, seed=2, impl="plain"))
    assert NK.LAUNCHES == before
    with pytest.raises(ValueError, match="features"):
        NK.noisy_matmul(x, torch.randn(9, 8), torch.tensor(0.1))
    with pytest.raises(ValueError, match="impl"):
        NK.noisy_matmul(x, w, torch.tensor(0.1), impl="cuda")
    # an empty K: the empty sum, zeros, as the CUDA route returns them
    y = NK.noisy_matmul(torch.randn(3, 0), torch.randn(0, 5),
                        torch.tensor(0.1), seed=2)
    assert torch.equal(y, torch.zeros(3, 5))
    assert NK.LAUNCHES == before


def test_noisy_weight_plain_is_the_plain_products_weight():
    """noisy_weight_plain is the w' inside noisy_matmul_plain bit for bit
    (the identity picks it out exactly): w + sigma * eps at the reference
    coordinates of the block."""
    gen = torch.Generator().manual_seed(2)
    w = torch.randn(70, 50, generator=gen)
    sig = torch.tensor(0.1) * w.abs().max()
    kw = dict(seed=3, bk_ref=32, bn_ref=16)
    wn = NK.noisy_weight_plain(w, sig, **kw)
    assert torch.equal(NK.noisy_matmul_plain(torch.eye(70), w, sig, **kw), wn)
    assert torch.equal(wn, w + sig * NK.weight_noise_eps(70, 50, 3, 32, 16))


@pytest.mark.parametrize("m,k,n", [(12544, 577, 64), (2048, 3584, 14336),
                                   (50, 300, 70), (64, 128, 64)])
def test_sgemm_geometry_fills_the_card(m, k, n):
    """The SGEMM's tile gives every H100 SM a block at the 7-layer CNN's
    conv5 and a gemma2-9b w_g in training (a smaller shape takes the
    smallest tile); the weight scratch is padded to whole k and column
    tiles, the shared memory as the kernel requests it."""
    tile = NK.sgemm_geometry(m, n)
    blocks = NK.sgemm_blocks(m, n, tile)
    assert blocks >= NK.H100_SMS or tile == len(NK.SGEMM_TILES) - 1
    if (m, n) in ((12544, 64), (2048, 14336)):
        assert blocks >= NK.H100_SMS
    assert NK.SGEMM_TILES[tile] == ((128, 256) if n > 64 and m >= 2048
                                    else (64, 64))
    kp, np_ = NK.padded_shape(k, n, tile)
    bk = NK.SGEMM_BK[tile]
    assert kp % bk == 0 and 0 <= kp - k < bk
    bn = NK.SGEMM_TILES[tile][1]
    assert np_ % bn == 0 and 0 <= np_ - n < bn
    assert [NK.shared_bytes(t) for t in range(2)] == [99328, 16896]


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    """The CUDA kernel against its plain version (the module docstring's
    tolerance), at a ragged shape, the reference test's shape, the 7-layer
    CNN's conv5 in training and a gemma2-9b w_g in training."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    for (m, k, n) in ((50, 300, 70), (64, 128, 64), (12544, 577, 64),
                      (2048, 3584, 14336), (3, 0, 5)):
        x = torch.randn(m, k, generator=gen, device=dev)
        w = torch.randn(k, n, generator=gen, device=dev)
        before = NK.LAUNCHES["noisy_matmul"]
        sig = 0.1 * w.abs().max() if k else torch.tensor(0.1, device=dev)
        got = NK.noisy_matmul(x, w, sig, seed=3)
        want = NK.noisy_matmul(x, w, sig, seed=3, impl="plain")
        torch.cuda.synchronize()
        assert NK.LAUNCHES["noisy_matmul"] == before + (k > 0)
        eps = NK.weight_noise_eps(k, n, 3, min(256, k), min(256, n), dev)
        tol = (2 * k + 8) * 2.0 ** -24 * (x.abs() @ (w.abs()
                                                    + sig * eps.abs()))
        assert bool(((got - want).abs() <= tol).all()), (m, k, n)


@pytest.mark.cuda
def test_kernel_parts_match_plain_on_card():
    """The wrapper's two kernels, each alone (its private launch helpers):
    the weight pass against noisy_weight_plain (its eps to a few ulps of
    PyTorch's log / cos, zeros in the padding) and the SGEMM against x @
    w' (f32 reassociation), at both tilings, ragged shapes included; two
    calls return equal tensors."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(1)
    for (m, k, n) in ((50, 300, 70), (12544, 577, 64), (512, 256, 1024)):
        x = torch.randn(m, k, generator=gen, device=dev)
        w = torch.randn(k, n, generator=gen, device=dev)
        sig = 0.1 * w.abs().max()
        want = NK.noisy_weight_plain(w, sig, seed=3, bk_ref=min(256, k),
                                     bn_ref=min(256, n))
        for tile in range(len(NK.SGEMM_TILES)):
            wn = NK._weight(w, sig, 3, min(256, k), min(256, n), tile)
            assert bool(((wn[:k, :n] - want).abs()
                         <= 1e-5 * sig + 2.0 ** -22 * w.abs()).all())
            assert bool((wn[k:] == 0).all()) and bool((wn[:, n:] == 0).all())
            y = NK._sgemm(x, wn, n, tile)
            ref = x @ wn[:k, :n]
            tol = (2 * k + 8) * 2.0 ** -24 * (x.abs() @ wn[:k, :n].abs())
            assert bool(((y - ref).abs() <= tol).all()), (m, k, n, tile)
            assert torch.equal(y, NK._sgemm(x, wn, n, tile))

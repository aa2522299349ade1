"""Synthetic data (PyTorch port of `repro/data/synthetic.py`: LM tokens,
the serving traffic stream, the CNNs' cluster images, the LSTM's keyword
MFCC series, and the RBM's binary patterns with their corruptions).

Every draw comes from an explicit `torch.Generator`, on its device; the
reference's jax.random streams are not replayed, so the parity tests hand
both packages the same numpy data instead.
"""
from __future__ import annotations

import math

import torch


def lm_tokens(generator: torch.Generator, batch: int, seq: int, vocab: int):
    """Uniform random token ids (int64, on the generator's device)."""
    return torch.randint(0, vocab, (batch, seq), generator=generator,
                         device=generator.device)


class Traffic(tuple):
    """Named fields of `traffic_requests` (a plain tuple with names)."""
    __slots__ = ()
    tokens = property(lambda s: s[0])     # (n, max_len) int64, right-padded 0
    lengths = property(lambda s: s[1])    # (n,) int64, page multiples
    mask = property(lambda s: s[2])       # (n, max_len) bool pad mask
    arrivals = property(lambda s: s[3])   # (n,) f32 Poisson arrival offsets
    gen = property(lambda s: s[4])        # (n,) int64 tokens to generate


def traffic_requests(generator: torch.Generator, n: int, vocab: int, *,
                     min_len: int = 32, max_len: int = 96, page: int = 32,
                     rate: float = 50.0, min_gen: int = 4,
                     max_gen: int = 16) -> Traffic:
    """Seeded open-loop traffic: n requests with mixed prompt lengths,
    right-padded token arrays + pad masks, per-request generation budgets
    and Poisson arrival times (exponential inter-arrivals at `rate`
    req/s), all on the generator's device.

    Prompt lengths are uniform over PAGE MULTIPLES in [min_len, max_len],
    so the engine's chunked prefill splits them at page edges as a paged
    KV allocator would. The same generator state gives the same traffic.
    """
    assert min_len % page == 0 and max_len % page == 0 and min_len >= page
    dev = generator.device
    pages = torch.randint(min_len // page, max_len // page + 1, (n,),
                          generator=generator, device=dev)
    lengths = pages * page
    tokens = torch.randint(0, vocab, (n, max_len), generator=generator,
                           device=dev)
    mask = torch.arange(max_len, device=dev)[None, :] < lengths[:, None]
    tokens = torch.where(mask, tokens, 0)
    inter = torch.empty((n,), device=dev).exponential_(
        generator=generator) / rate
    arrivals = torch.cumsum(inter, 0).to(torch.float32)
    gen = torch.randint(min_gen, max_gen + 1, (n,), generator=generator,
                        device=dev)
    return Traffic((tokens, lengths, mask, arrivals, gen))


def cluster_images(generator: torch.Generator, n: int, hw: int = 16,
                   channels: int = 1, classes: int = 10, noise: float = 0.25,
                   proto_seed: int = 7):
    """Images = smoothed class prototype + pixel noise, in [0, 1]; shapes
    mirror the paper's benchmarks (MNIST 28x28x1, CIFAR-10 32x32x3). The
    prototypes come from their own generator seeded `proto_seed`, so sets
    drawn from different generators share the task. Returns ((n, hw, hw,
    channels) float32, (n,) int64 labels), on the generator's device."""
    dev = generator.device
    proto = torch.Generator(dev).manual_seed(proto_seed)
    protos = torch.rand((classes, hw, hw, channels), generator=proto,
                        device=dev)
    labels = torch.randint(0, classes, (n,), generator=generator, device=dev)
    eps = torch.randn((n, hw, hw, channels), generator=generator, device=dev)
    return compose_images(protos, labels, eps, noise), labels


def compose_images(protos, labels, eps, noise: float = 0.25):
    """The deterministic half of `cluster_images`: smooth each (classes,
    hw, hw, C) prototype channel with a 3x3 box filter at zero 'same'
    padding (as `convolve2d(mode="same")` does), then image = clip(proto
    [label] + noise * eps, 0, 1)."""
    k, hw, _, c = protos.shape
    planes = protos.permute(0, 3, 1, 2).reshape(k * c, 1, hw, hw)
    box = torch.full((1, 1, 3, 3), 1.0 / 9.0, device=protos.device)
    smooth = torch.nn.functional.conv2d(planes, box, padding=1)
    smooth = smooth.reshape(k, c, hw, hw).permute(0, 2, 3, 1)
    return torch.clamp(smooth[labels] + noise * eps, 0.0, 1.0)


def keyword_mfcc(generator: torch.Generator, n: int, t: int = 50,
                 f: int = 40, classes: int = 12, noise: float = 0.4,
                 proto_seed: int = 11):
    """Synthetic MFCC series (the paper's 50 x 40 speech commands): class
    frequency trajectories + noise. The per-class frequencies (U[0.3, 3))
    and amplitudes (U[0.5, 2)) come from their own generator seeded
    `proto_seed`, so sets drawn from different generators share the task;
    labels, phases (U[0, 2 pi)) and noise from `generator`. Returns ((n,
    t, f) float32, (n,) int64 labels), on the generator's device."""
    dev = generator.device
    proto = torch.Generator(dev).manual_seed(proto_seed)
    freq = 0.3 + 2.7 * torch.rand((classes, f), generator=proto, device=dev)
    amp = 0.5 + 1.5 * torch.rand((classes, f), generator=proto, device=dev)
    labels = torch.randint(0, classes, (n,), generator=generator, device=dev)
    phase = 2 * math.pi * torch.rand((n, 1, f), generator=generator,
                                     device=dev)
    eps = torch.randn((n, t, f), generator=generator, device=dev)
    return compose_mfcc(freq, amp, labels, phase, eps, noise), labels


def compose_mfcc(freq, amp, labels, phase, eps, noise: float = 0.4):
    """The deterministic half of `keyword_mfcc`: x[b, s] = amp[label] *
    sin(freq[label] * 2 pi s / t + phase[b]) + noise * eps[b, s], for
    (classes, f) freq / amp, (n,) labels, (n, 1, f) phases and (n, t, f)
    eps."""
    t = eps.shape[1]
    ts = torch.arange(t, device=eps.device, dtype=torch.float32)[
        None, :, None] / t * 2 * math.pi
    x = amp[labels][:, None, :] * torch.sin(freq[labels][:, None, :] * ts
                                            + phase)
    return x + noise * eps


def binary_patterns(generator: torch.Generator, n: int, d: int = 784,
                    rank: int = 12, labels_dim: int = 10,
                    proto_seed: int = 13):
    """Structured binary patterns for the RBM: low-rank Bernoulli logits,
    with a one-hot 'label' block appended (paper: 784 pixels + 10 labels).
    The rank-space prototype comes from its own generator seeded
    `proto_seed`, so sets drawn from different generators share the task.
    Returns (n, d + labels_dim) float32."""
    dev = generator.device
    proto = torch.Generator(dev).manual_seed(proto_seed)
    u = torch.randn((n, rank), generator=generator, device=dev)
    v = torch.randn((rank, d), generator=proto, device=dev) * 2.0
    pix = torch.bernoulli(torch.sigmoid(u @ v), generator=generator)
    lab = torch.nn.functional.one_hot(
        torch.randint(0, labels_dim, (n,), generator=generator, device=dev),
        labels_dim).to(torch.float32)
    return torch.cat([pix, lab], dim=-1)


def corrupt_flip(generator: torch.Generator, v, frac: float = 0.2,
                 pixels: int = 784):
    """Flip a random `frac` of the pixel block to complementary intensity.
    Returns (corrupted v, mask of trusted entries)."""
    flip = (torch.rand(v.shape, generator=generator, device=v.device) < frac) \
        & (torch.arange(v.shape[-1], device=v.device) < pixels)
    return torch.where(flip, 1.0 - v, v), ~flip


def corrupt_occlude(v, frac: float = 1 / 3, pixels: int = 784):
    """Zero the bottom `frac` of the pixel block (occlusion). Returns
    (corrupted v, mask of trusted entries)."""
    cut = int(pixels * (1 - frac))
    idx = torch.arange(v.shape[-1], device=v.device)
    occluded = (idx >= cut) & (idx < pixels)
    return torch.where(occluded, torch.zeros((), device=v.device), v), \
        ~occluded

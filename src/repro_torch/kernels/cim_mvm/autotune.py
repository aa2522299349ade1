"""Launch-geometry autotuner for the packed CIM kernels (port of
`repro/kernels/cim_mvm/autotune.py`).

The reference tunes bm, the batch rows of a Pallas grid step. On the card
bm does nothing for speed: it keys only the stochastic neuron's draws
(`ops.packed_call`), so `lookup` returns the reference's default, 256,
and nothing tunes it. What the Hopper kernels choose is their launch
route, by rule: the split route at M <= 16 rows (`kernel.split_route`)
and the walk's item layout from WALK_ITEMS (`kernel.walk_geometry`). The
port's candidates are those rules' alternatives for a plan and a batch
(`kernel.Route`): at M <= 16 the split route and each walk layout that
fits M, above 16 each walk layout that fits M; a transposed plan has the
walk only.

`tune` sweeps the candidates for one (plan, batch, activation) signature:
each is checked by the verifier's `shared-memory` invariant (a candidate
that fails it is skipped; any other invariant fails the sweep), then run
and held against the default route's output bit for bit (a candidate
that differs raises), then timed (an injectable timer; by default CUDA
events over calls enqueued behind a spin of the card, best of n after one
warm-up). The winner is cached per
`plan_signature`, the batch bucketed to the next power of two, and
`ops.packed_call` takes it through `lookup_route` wherever the caller
leaves the route open; the walk's memoised launch geometry is keyed by
the layout, so it cannot go stale.

A deliberate difference from the reference: a tuned winner never changes
an output here. The reference's tuned bm re-keys the stochastic draws.

The plan-time half is the reference's: `tiling_candidates` halves the
core caps and prunes to the chip's cores, `retile` re-packs a layer's
conductances on a uniform grid (`core.mapping.Tile` / `pack_tiles`), and
`tune_tiling` runs `tune` on each re-pack and caches the winning (bk, bn)
per layer shape. A re-tiled layer is a different chip (every tile's ADC
quantizes its own partial sum), so nothing on the serving path re-tiles.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from .kernel import RULE, Route, split_route, walk_layouts

_DEFAULT_BM = 256
_CACHE: Dict[tuple, Route] = {}
_TILE_CACHE: Dict[tuple, Tuple[int, int]] = {}


def _bucket(m: int) -> int:
    """Next power of two >= m (batch bucket for the cache key)."""
    b = 1
    while b < m:
        b *= 2
    return b


def plan_signature(packed, m: int, activation: str) -> tuple:
    """Hashable key describing everything the best route can depend on:
    the plan's static geometry (block sizes, index maps, pass/run
    structure, direction) plus the power-of-two batch bucket and the
    epilogue."""
    return (_bucket(max(int(m), 1)), packed.bk, packed.bn,
            packed.row_block, packed.out_slot, packed.out_col,
            packed.n_passes, packed.transpose, activation)


def lookup(packed, m: int, activation: str) -> int:
    """The batch block bm for this signature: always the reference's
    default, 256 (on the card bm keys the stochastic draws and nothing
    else, so it is never tuned)."""
    return _DEFAULT_BM


def lookup_route(packed, m: int, activation: str) -> Optional[Route]:
    """Cached winning route for this signature, or None before tuning (the
    kernels' rule)."""
    if not _CACHE:
        return None
    return _CACHE.get(plan_signature(packed, m, activation))


def candidates(m: int, transpose: bool = False) -> Tuple[Route, ...]:
    """Route candidates for a batch of m rows: the split route where it
    can run (m <= 16, forward plans), then each walk layout that fits m."""
    m = max(int(m), 1)
    out = [Route("split")] if split_route(m) and not transpose else []
    return tuple(out + [Route("walk", lay) for lay in walk_layouts(m)])


# cycles of a spin kernel per timed call: ~1 ms at 1.98 GHz covers a
# wrapper's host time, so the host enqueues the calls while the card is
# still busy and the events hold the card's time
_SPIN_CYCLES = 2_000_000


def _best_of(fn: Callable[[], None], n: int = 3, reps: int = 10) -> float:
    """Default timer: one untimed warm-up call, then the best of n windows,
    each `reps` calls enqueued behind a spin of the card and timed by CUDA
    events on the current stream: milliseconds of the card per call, the
    wrapper's host time hidden (a decode-sized launch is shorter than its
    host time, which would otherwise decide the sweep). Pass timer= to
    time anything but the card."""
    if not torch.cuda.is_available():
        raise RuntimeError("the default timer times the card with CUDA "
                           "events; pass timer= to tune elsewhere")
    fn()
    best = float("inf")
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(_SPIN_CYCLES * reps)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def _bits(t):
    return t.contiguous().view(torch.int32)


def tune(x, packed, *, activation: str, n_max: int, v_read: float,
         seed: int = 0, timer: Optional[Callable] = None,
         refresh: bool = False):
    """Measure every route candidate for this (plan, batch, activation),
    cache and return the winner.

    timer: fn(thunk) -> a comparable duration (only the argmin matters);
    defaults to `_best_of` (the card's ms per call). refresh:
    re-measure even on a cache hit (a hit otherwise returns the cached
    winner with an empty timing dict).

    Every candidate is checked by `core.verify.check_packed` at its route
    BEFORE it runs: one whose block busts Hopper's shared memory is
    skipped; any other invariant fails the sweep (a corrupt plan). Each
    candidate's output must then equal the default route's bit for bit,
    or the sweep raises.

    Returns (winner_route, {route: duration}).
    """
    from ...core.verify import ChipVerifyError, check_packed
    from .ops import packed_call     # late: ops imports this module

    m = x.shape[0]
    key = plan_signature(packed, m, activation)
    if key in _CACHE and not refresh:
        return _CACHE[key], {}
    timer = timer or _best_of
    kw = dict(activation=activation, n_max=n_max, v_read=v_read, seed=seed)
    # the default route: the kernels' rule, whatever the cache holds
    check_packed(packed, bm=m)
    want = _bits(packed_call(x, packed, route=RULE, **kw))
    timings: Dict[Route, float] = {}
    skipped: Dict[Route, str] = {}
    for route in candidates(m, packed.transpose):
        try:
            check_packed(packed, bm=m, route=route)
        except ChipVerifyError as e:
            if e.invariant != "shared-memory":
                raise                # corrupt plan: no route can fix it
            skipped[route] = str(e)
            continue
        got = _bits(packed_call(x, packed, route=route, **kw))
        if not torch.equal(got, want):
            raise RuntimeError(
                f"route {route} of plan '{packed.layer}' at {m} rows "
                "differs from the default route's output")

        def run(route=route):
            packed_call(x, packed, route=route, **kw)
        timings[route] = timer(run)
    if not timings:
        raise ChipVerifyError(
            "pack", "shared-memory",
            f"every route candidate {[str(r) for r in skipped]} busts the "
            f"shared memory for plan '{packed.layer}' (bk={packed.bk}, "
            f"bn={packed.bn}): " + next(iter(skipped.values())),
            layer=packed.layer)
    winner = min(timings, key=timings.get)
    _CACHE[key] = winner
    return winner, timings


# ------------------------------------------------ plan-time re-tiling

def tiling_signature(n_rows: int, n_cols: int, m: int, activation: str,
                     fold_norm: bool) -> tuple:
    """Cache key for a tiling winner: the layer's logical shape, the
    batch bucket and the epilogue/denorm mode — everything the best tile
    geometry can depend on at plan time."""
    return (_bucket(max(int(m), 1)), int(n_rows), int(n_cols),
            activation, bool(fold_norm))


def lookup_tiling(n_rows: int, n_cols: int, m: int, activation: str,
                  fold_norm: bool = False) -> Optional[Tuple[int, int]]:
    """Cached winning (bk, bn) for this layer-shape signature, or None
    before any `tune_tiling` (callers keep the planner default — the
    full-core geometry of core/mapping.plan_layers)."""
    return _TILE_CACHE.get(
        tiling_signature(n_rows, n_cols, m, activation, fold_norm))


def tiling_candidates(n_rows: int, n_cols: int, spec=None
                      ) -> Tuple[Tuple[int, int], ...]:
    """(bk, bn) candidates for a (n_rows, n_cols) layer: halvings of the
    physical core caps (128 differential weight rows x 256 columns for
    the NeuRRAM TNSA), clamped to the layer and deduplicated. Finer
    tilings that would need more tiles than the chip has cores are
    skipped — an unmerged single-pass pack claims one core per tile. The
    coarsest geometry (the planner's own choice) is always first."""
    from ...core.types import CoreSpec
    spec = spec or CoreSpec()
    row_cap, col_cap = spec.rows // 2, spec.cols
    out = []
    for bk in (row_cap, row_cap // 2, row_cap // 4):
        for bn in (col_cap, col_cap // 2, col_cap // 4):
            cand = (min(bk, int(n_rows)), min(bn, int(n_cols)))
            n_tiles = (-(-int(n_rows) // cand[0])
                       * (-(-int(n_cols) // cand[1])))
            if cand not in out and (n_tiles <= spec.n_cores
                                    or not out):
                out.append(cand)
    return tuple(out)


def retile(gd, bk: int, bn: int, *, layer: str = "layer", gsum=None,
           v_decr=1.0, fold_norm: bool = False):
    """Re-pack a layer's (R, C) conductance matrices at an alternative
    (bk, bn) tile geometry: the stage-1 splitter's uniform grid at
    explicit caps instead of the physical maxima. The result is a
    complete PackedPlan over the SAME gd/gsum values. v_decr is a scalar
    (per-tile calibration belongs to the old geometry and cannot carry
    over — a retiled chip recalibrates)."""
    from ...core.mapping import Tile, pack_tiles
    R, C = gd.shape[-2], gd.shape[-1]
    if not (0 < bk <= R and 0 < bn <= C):
        raise ValueError(f"tile caps ({bk},{bn}) outside layer ({R},{C})")
    tiles = [Tile(layer, i * bk, j * bn,
                  min(bk, R - i * bk), min(bn, C - j * bn))
             for i in range(-(-R // bk)) for j in range(-(-C // bn))]
    return pack_tiles(tiles, gd, gsum=gsum, v_decr=v_decr,
                      fold_norm=fold_norm)


def tune_tiling(x, gd, *, activation: str, n_max: int, v_read: float,
                gsum=None, v_decr=1.0, fold_norm: bool = False,
                layer: str = "layer", spec=None, seed: int = 0,
                timer: Optional[Callable] = None, refresh: bool = False):
    """Sweep the tile geometry for one layer: re-pack at every
    `tiling_candidates` (bk, bn), run `tune` on each candidate plan (its
    routes checked and held to its default route's output, then timed),
    and cache the winner per `tiling_signature`.

    Returns (winner_(bk, bn), {(bk, bn): best duration}). A cache hit
    without `refresh` returns the cached winner with an empty timing
    dict. Candidates whose every route busts the shared memory are
    skipped."""
    from ...core.verify import ChipVerifyError

    key = tiling_signature(gd.shape[-2], gd.shape[-1], x.shape[0],
                           activation, fold_norm)
    if key in _TILE_CACHE and not refresh:
        return _TILE_CACHE[key], {}
    timings: Dict[Tuple[int, int], float] = {}
    for bk, bn in tiling_candidates(gd.shape[-2], gd.shape[-1], spec):
        packed = retile(gd, bk, bn, layer=layer, gsum=gsum,
                        v_decr=v_decr, fold_norm=fold_norm)
        try:
            best, sweeps = tune(x, packed, activation=activation,
                                n_max=n_max, v_read=v_read, seed=seed,
                                timer=timer, refresh=True)
        except ChipVerifyError as e:
            if e.invariant != "shared-memory":
                raise
            continue
        timings[(bk, bn)] = sweeps[best]
    if not timings:
        raise ChipVerifyError(
            "pack", "shared-memory",
            f"every tiling candidate for layer '{layer}' "
            f"({gd.shape[-2]}x{gd.shape[-1]}) busts the shared memory",
            layer=layer)
    winner = min(timings, key=timings.get)
    _TILE_CACHE[key] = winner
    return winner, timings


def clear() -> None:
    """Drop every cached winner, route and tiling (test isolation)."""
    _CACHE.clear()
    _TILE_CACHE.clear()

"""Parity harness between the JAX reference (`repro`) and the PyTorch port
(`repro_torch`).

Inputs are made once, with numpy or with the reference's own seeded
streams, and handed to both packages as numpy arrays. JAX is imported
inside the helpers that need it, so a test file can also run where only
the port is installed (its CUDA tests on a GPU host without JAX).

Tolerances (the north star in ROADMAP.md):
  * plans, schedules and every index map are compared exactly;
  * f32 tensors the two packages compute independently (conductance
    blocks, normalizers, ADC steps) agree to F32_RTOL: a few roundings of
    sums taken in another order;
  * ADC counts agree exactly except where the reference |q|/v_decr lies
    within rounding of a .5 boundary (`boundary_hits`).
"""
from __future__ import annotations

import numpy as np
import torch

# sums of up to a few hundred f32 terms in another order, then a divide
F32_RTOL = 2e-6


def to_torch(a, device="cpu", dtype=None):
    t = torch.from_numpy(np.array(a))
    return t.to(device=device, dtype=dtype) if dtype else t.to(device)


def to_numpy(t):
    return t.detach().cpu().numpy()


def packed_to_torch(pj, device="cpu"):
    """The port's PackedPlan holding exactly the tensors of a reference
    PackedPlan, so an executor test feeds both packages the same plan."""
    from repro_torch.core.mapping import PackedPlan
    return PackedPlan(
        layer=pj.layer, bk=pj.bk, bn=pj.bn, n_rows=pj.n_rows,
        n_cols=pj.n_cols, row_block=pj.row_block, col_block=pj.col_block,
        seq_slot=pj.seq_slot, n_passes=pj.n_passes, transpose=pj.transpose,
        tile_slot=pj.tile_slot, out_slot=pj.out_slot, out_col=pj.out_col,
        gd_tiles=to_torch(pj.gd_tiles, device),
        inv_norm_tiles=to_torch(pj.inv_norm_tiles, device),
        v_decr_tiles=to_torch(pj.v_decr_tiles, device),
        denorm_tiles=to_torch(pj.denorm_tiles, device))


def boundary_hits(x, packed, v_read: float, activation: str = "none",
                  seed: int = 0):
    """Per output element, the number of contributing tiles where two
    correct f32 executions may decide differently: the exact |q|/v_decr
    within f32 rounding of a .5 boundary, or for stochastic bits q plus the
    noise within rounding of 0 (see `repro_torch.kernels.cim_mvm.kernel
    .boundary_counts`). x: (M, K) numpy; packed: the port's PackedPlan of
    any route. Returns (M, n_cols) numpy."""
    from repro_torch.kernels.cim_mvm.kernel import boundary_counts
    hits = boundary_counts(
        to_torch(x, packed.gd_tiles.device, torch.float32), packed.gd_tiles,
        packed.inv_norm_tiles, packed.v_decr_tiles, packed.row_index,
        packed.run_start, packed.col_run_start, packed.col_runs,
        tile_index=packed.tile_index, n_run_ranks=packed.n_run_ranks,
        n_run_len=packed.n_run_len, v_read=v_read, activation=activation,
        seed=seed)
    return to_numpy(hits)[:, :packed.n_cols]


def assert_counts_match(got, want, hits, den_max=1.0):
    """Accumulated ADC outputs agree exactly wherever no contributing tile
    sits on a .5 boundary; elsewhere each boundary tile may move its
    output by one count (times its accumulation weight)."""
    got, want = np.asarray(got), np.asarray(want)
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64))
    clean = hits == 0
    assert np.array_equal(got[clean], want[clean]), (
        f"{int((got[clean] != want[clean]).sum())} outputs off the .5 "
        f"boundaries differ (max |diff| {diff[clean].max()})")
    assert np.all(diff <= hits * den_max * (1 + 1e-6) + 1e-6 * np.abs(want)), \
        "a boundary output moved by more than one count per boundary tile"


def reference_x_cal(key, stacked, in_alpha, n_shards: int = 1):
    """The calibration batches the reference's tp=1 deploy draws
    (nn._deploy_sharded_stacks -> deploy_packed_stack -> program_chip):
    layer li, projection i (sorted order) draws
    alpha * truncated_normal(split(fold_in(fold_in(fold_in(key,
    n_shards), li), i))[1], -2, 2, (64, R)), alpha the projection's clip
    (in_alpha: a float, or a per-name dict). Returns a per-layer list of
    name -> numpy (64, R)."""
    import jax
    names = sorted(stacked)
    k_stack = jax.random.fold_in(key, n_shards)
    n_layers = stacked[names[0]].shape[0]
    out = []
    for li in range(n_layers):
        k_layer = jax.random.fold_in(k_stack, li)
        batches = {}
        for i, n in enumerate(names):
            _, k_syn = jax.random.split(jax.random.fold_in(k_layer, i))
            alpha = in_alpha[n] if isinstance(in_alpha, dict) else in_alpha
            batches[n] = np.array(alpha * jax.random.truncated_normal(
                k_syn, -2.0, 2.0, (64, stacked[n].shape[1])))
        out.append(batches)
    return out


def assert_chip_match(pcl, pj, what):
    """The port's PackedCIMLayer `pcl` against one reference chip `pj`
    (its arrays as numpy): plan and index maps exact, programmed tiles
    equal, calibrated tensors to f32 rounding."""
    for f in ("bk", "bn", "n_rows", "n_cols", "row_block", "col_block",
              "seq_slot", "tile_slot", "out_slot", "out_col", "n_passes"):
        assert getattr(pcl.packed, f) == getattr(pj.packed, f), (what, f)
    np.testing.assert_array_equal(to_numpy(pcl.packed.gd_tiles),
                                  pj.packed.gd_tiles, err_msg=what)
    for f in ("inv_norm_tiles", "v_decr_tiles", "denorm_tiles"):
        np.testing.assert_allclose(to_numpy(getattr(pcl.packed, f)),
                                   getattr(pj.packed, f), rtol=1e-5,
                                   err_msg=f"{what} {f}")


def with_biases(params, seed: int = 11, scale: float = 0.5):
    """The reference's params with the QKV biases bq, bk, bv (zeros at
    init) replaced by seeded nonzero values, `scale` * normal, so a
    comparison exercises the bias path."""
    import jax.numpy as jnp
    lay = dict(params["layers"])
    rng = np.random.default_rng(seed)
    for n in ("bq", "bk", "bv"):
        if n in lay:
            lay[n] = jnp.asarray(scale * rng.standard_normal(lay[n].shape),
                                 jnp.float32)
    return dict(params, layers=lay)


def frontend_inputs(cfg, batch: int, src_len: int, seed: int = 3):
    """Seeded numpy stub-frontend embeddings, 0.02 * normal as the
    reference's drivers draw them: "vis_embeds" (batch, vis_patches, d)
    for a VLM, "src_embeds" (batch, src_len, d) for an encoder-decoder."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.vis_patches:
        out["vis_embeds"] = (0.02 * rng.standard_normal(
            (batch, cfg.vis_patches, cfg.d_model))).astype(np.float32)
    if cfg.enc_layers:
        out["src_embeds"] = (0.02 * rng.standard_normal(
            (batch, src_len, cfg.d_model))).astype(np.float32)
    return out

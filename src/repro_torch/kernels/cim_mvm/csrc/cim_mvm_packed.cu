// Packed whole-layer NeuRRAM CIM MVM for Hopper (sm_90a).
//
// Replaces repro/kernels/cim_mvm/kernel.py:238 cim_mvm_packed_pallas (the
// Pallas TPU kernel `_cim_packed_kernel` with its `_epilogue`,
// `_acc_weight` and `_pwl_tanh`): a single-pass tile plan of one layer,
//   q      = x[:, row_block[t]] @ gd_tiles[t] * v_read * inv_norm[t]
//   counts = ADC epilogue of q (charge-decrement rounding + activation)
//   out[:, col_block[t]] += counts * weight[t]      in slot order.
//
// What bounds it: every gd_tiles element (one full-width gemma2-9b layer
// holds 793 MB of them) feeds M multiply-adds. At small M the kernel is
// bound by gd's bytes, read once; at prefill (M = 256) by the card's FP64
// rate (no TF32: the counts round at .5 boundaries).
//
// Two routes, picked by the wrapper from M (kernel.py `split_route`):
//   * at decode, up to the measured edge, the split route (cim_split.cuh,
//     `cim_mvm_packed_split_launch`), against gd's bytes: one block per
//     tile streams it through shared memory with bulk copies and writes
//     its terms counts * weight; a second kernel folds each column block's
//     terms in slot order. All 132 SMs pull tiles at once.
//   * above it, the walk (cim_walk.cuh, `cim_mvm_packed_launch`), against
//     the FP64 rate: the tile dots on the FP64 tensor cores (mma.sync
//     m16n8k4), gd and x staged through a ring of bulk copies, items of up
//     to 64 rows x 64 columns sized so that every SM has one, each item's
//     column block walked in slot order with its sums in registers. The
//     packed plan is the walk with one run per column block: run_start =
//     col_start, no column-run tables.
// Both routes:
//   * the dot is EXACT in FP64 (cim_dmma.cuh), so its one rounding to f32
//     is the correctly rounded dot and the plain version (an FP64 batched
//     matmul) agrees bit for bit.
//   * the epilogue and `out += counts * weight` follow the reference
//     operation by operation (cim_epilogue.cuh `tile_term`).
//   * ragged rows and columns are masked, not padded.
// Both take dynamic shared memory: the walk's `walk_shared_bytes`, the
// split route's term block `split_shared_bytes`.
#include "cim_epilogue.cuh"
#include "cim_split.cuh"
#include "cim_walk.cuh"

extern "C" {

// Launches the walk, `grid` blocks, on `stream` (run_start = col_start;
// col_run_start and col_runs unused); returns a CUDA error code (0 =
// launched).
int cim_mvm_packed_launch(const cim::WalkArgs* a, const cim::WalkGeometry* g,
                          const cim::Epilogue* e, int grid, void* stream) {
  cim::WalkArgs args = *a;
  args.col_run_start = nullptr;
  args.col_runs = nullptr;
  return cim::walk_launch<false, false>(args, *g, *e, grid,
                                        static_cast<cudaStream_t>(stream));
}

// Walk blocks of geometry g resident on one SM of the current device (a
// negative CUDA error code on failure).
int cim_mvm_packed_occupancy(const cim::WalkGeometry* g) {
  return cim::walk_occupancy<false, false>(*g);
}

// Dynamic shared memory of one walk block of geometry g.
int cim_mvm_packed_shared_bytes(const cim::WalkGeometry* g) {
  return cim::walk_shared_bytes(*g);
}

// The split route (cim_split.cuh) for M <= 16 rows at `bm` = 4 or 16: the
// term pass over every slot (live = nullptr, n_live = the slot count),
// then the fold. A single-pass plan's runs are its column blocks:
// run_start = col_start, col_run_start = col_runs = nullptr. terms: a
// (T, M, bn) scratch. Returns the first CUDA error (0 = launched).
int cim_mvm_packed_split_launch(const float* x, int M, int K, const float* gd,
                                const float* inv_norm, const float* denorm,
                                const float* v_decr, const int* row_block,
                                const int* run_start, const int* col_run_start,
                                const int* col_runs, const int* live,
                                int n_live, int n_col_blocks, int bk, int bn,
                                float* terms, float* out,
                                const cim::Epilogue* e, int bm, void* stream) {
  const cim::SplitArgs a{x, M, K, gd, inv_norm, denorm, v_decr, row_block,
                         live, bk, bn, terms, run_start, col_run_start,
                         col_runs, n_col_blocks, out};
  return cim::split_launch_bm(a, n_live, *e, bm,
                              static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory the split launch requests per term block (-1 for
// an unsupported bm).
int cim_mvm_packed_split_shared_bytes(int bm, int bk, int bn) {
  return (bm == 4 || bm == 16) ? cim::split_shared_bytes(bm, bk, bn) : -1;
}

}  // extern "C"

// Scheduled (merged-core) whole-layer NeuRRAM CIM MVM for Hopper (sm_90a).
//
// Replaces repro/kernels/cim_mvm/kernel.py:351 cim_mvm_scheduled_pallas
// (the Pallas TPU kernel `_cim_sched_kernel` and the wrapper's
// `_fold_runs`): a tile plan whose merged cores serialize into passes, on
// the pass-major FUSED slot order (core/mapping._fused_layout). A RUN is a
// stretch of consecutive slots of one output column block; a column block
// revisited in a later pass spans several runs. The reference accumulates
// each run from zero on its sequential grid, then folds the runs of a
// column block in run order after the launch:
//   part_r = sum over the run's slots, in slot order, of counts * weight
//   out[:, j] = ((0 + part_r0) + part_r1) + ...   over j's live runs
// With fold_norm denorms the terms are not integers, so this grouping, and
// not one left fold over all of j's slots, fixes the bits.
//
// What bounds it: as the packed kernel, gd's bytes (of the live tiles) at
// small M and the FP64 rate at prefill (M = 256). Idle slots (a pass's
// padding) are work the function does not need: their runs (out_col ==
// -1) are never read.
//
// Two routes, picked by the wrapper from M (kernel.py `split_route`):
//   * at decode, up to the measured edge, the split route (cim_split.cuh,
//     `cim_mvm_scheduled_split_launch`), against the bytes: one block per
//     LIVE slot streams its tile through shared memory with bulk copies
//     and writes its terms; a second kernel gives each output one thread
//     that walks its column block's live runs in run order and each run's
//     slots in slot order, summing each run from zero and folding the
//     runs.
//   * above it, the walk (cim_walk.cuh, `cim_mvm_scheduled_launch`),
//     against the FP64 rate: the tile dots on the FP64 tensor cores
//     (mma.sync m16n8k4), gd and x staged through a ring of bulk copies,
//     items of up to 64 rows x 64 columns sized so that every SM has one;
//     an item walks its column block's live runs in run order
//     (col_run_start / col_runs), each run's slots in slot order
//     (run_start), each run summed into a register partial from zero and
//     added to the item's total: one write per output, no atomics, no
//     reduction across blocks. Ragged columns (bn = 47 on the IR-drop
//     chip) are masked.
// Both take dynamic shared memory: the walk's `walk_shared_bytes`, the
// split route's term block `split_shared_bytes`.
#include "cim_epilogue.cuh"
#include "cim_split.cuh"
#include "cim_walk.cuh"

extern "C" {

// Launches the walk, `grid` blocks, on `stream`; returns a CUDA error
// code (0 = launched).
int cim_mvm_scheduled_launch(const cim::WalkArgs* a,
                             const cim::WalkGeometry* g,
                             const cim::Epilogue* e, int grid, void* stream) {
  return cim::walk_launch<true, false>(*a, *g, *e, grid,
                                       static_cast<cudaStream_t>(stream));
}

// Walk blocks of geometry g resident on one SM of the current device (a
// negative CUDA error code on failure).
int cim_mvm_scheduled_occupancy(const cim::WalkGeometry* g) {
  return cim::walk_occupancy<true, false>(*g);
}

// Dynamic shared memory of one walk block of geometry g.
int cim_mvm_scheduled_shared_bytes(const cim::WalkGeometry* g) {
  return cim::walk_shared_bytes(*g);
}

// The split route (cim_split.cuh) for M <= 16 rows at `bm` = 4 or 16: the
// term pass over the plan's n_live live slots (`live`, in slot order),
// then the fold over each column block's live runs. terms: a (T, M, bn)
// scratch. Returns the first CUDA error (0 = launched).
int cim_mvm_scheduled_split_launch(const float* x, int M, int K,
                                   const float* gd, const float* inv_norm,
                                   const float* denorm, const float* v_decr,
                                   const int* row_block, const int* run_start,
                                   const int* col_run_start,
                                   const int* col_runs, const int* live,
                                   int n_live, int n_col_blocks, int bk,
                                   int bn, float* terms, float* out,
                                   const cim::Epilogue* e, int bm,
                                   void* stream) {
  const cim::SplitArgs a{x, M, K, gd, inv_norm, denorm, v_decr, row_block,
                         live, bk, bn, terms, run_start, col_run_start,
                         col_runs, n_col_blocks, out};
  return cim::split_launch_bm(a, n_live, *e, bm,
                              static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory the split launch requests per term block (-1 for
// an unsupported bm).
int cim_mvm_scheduled_split_shared_bytes(int bm, int bk, int bn) {
  return (bm == 4 || bm == 16) ? cim::split_shared_bytes(bm, bk, bn) : -1;
}

}  // extern "C"

// Scheduled (merged-core) whole-layer NeuRRAM CIM MVM for Hopper (sm_90a).
//
// Replaces repro/kernels/cim_mvm/kernel.py::cim_mvm_scheduled_pallas (the
// Pallas TPU kernel `_cim_sched_kernel` and the wrapper's `_fold_runs`):
// a tile plan whose merged cores serialize into passes, on the pass-major
// FUSED slot order (core/mapping._fused_layout). A RUN is a stretch of
// consecutive slots of one output column block; a column block revisited
// in a later pass spans several runs. The reference accumulates each run
// from zero on its sequential grid, then folds the runs of a column block
// in run order after the launch:
//   part_r = sum over the run's slots, in slot order, of counts * weight
//   out[:, j] = ((0 + part_r0) + part_r1) + ...   over j's live runs
// With fold_norm denorms the terms are not integers, so this grouping, and
// not one left fold over all of j's slots, fixes the bits.
//
// What bounds it: as the packed kernel, the bytes of the live tiles at
// decode and the FP64 rate at prefill. Idle slots (a pass's padding) are
// work the function does not need: their runs (out_col == -1) are never
// read.
//
// Two routes, picked by the wrapper from M (kernel.py `split_route`):
//   * M <= 16, the split route (cim_split.cuh, `_split_launch` below): one
//     block per LIVE slot (the plan's live-slot table) streams its tile
//     through shared memory with bulk copies and writes its terms; a
//     second kernel gives each output one thread that walks its column
//     block's live runs in run order and each run's slots in slot order,
//     summing each run from zero and folding the runs: the reference's
//     grouping, without the walk's idle SMs.
//   * M > 16, the walk (this file's kernel, unchanged): a block owns BM
//     rows x 128 columns of one output column block j and walks j's live
//     runs in run order (col_run_start / col_runs), each run's slots in
//     slot order (run_start), with the packed kernel's exact FP64 tile dot
//     (cim_epilogue.cuh). Each run sums into a register partial from zero,
//     which is added to the block's total: one write per output, no
//     atomics, no reduction across blocks. Ragged columns (bn = 47 on the
//     IR-drop chip leaves 81 of 128 threads without a column) are masked.
// Shared memory per walk block: kChunk * (BM + 2) * 8 bytes (static); the
// split route's term block takes dynamic shared memory (cim_split.cuh).
#include "cim_epilogue.cuh"
#include "cim_split.cuh"

namespace {

using namespace cim;

template <int BM>
__global__ void __launch_bounds__(kThreads)
cim_mvm_scheduled_kernel(const float* __restrict__ x, int M, int K,
                         const float* __restrict__ gd,
                         const float* __restrict__ inv_norm,
                         const float* __restrict__ denorm,
                         const float* __restrict__ v_decr,
                         const int* __restrict__ row_block,
                         const int* __restrict__ run_start,
                         const int* __restrict__ col_run_start,
                         const int* __restrict__ col_runs,
                         int bk, int bn, int n_sub,
                         float* __restrict__ out, int out_ld, Epilogue e) {
  __shared__ __align__(16) double xs[kChunk][BM + 2];
  const int m0 = blockIdx.x * BM;
  const int cb = blockIdx.y / n_sub;
  const int c = (blockIdx.y % n_sub) * kThreads + threadIdx.x;
  const bool live = c < bn;

  float total[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) total[r] = 0.f;

  const int k_end = col_run_start[cb + 1];
  for (int k = col_run_start[cb]; k < k_end; ++k) {
    const int run = col_runs[k];
    float part[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) part[r] = 0.f;
    const int t_end = run_start[run + 1];
    for (int t = run_start[run]; t < t_end; ++t) {
      double acc[BM];
      fwd_tile_dot<BM>(xs, x, M, K, m0, row_block[t] * bk,
                       gd + (size_t)t * bk * bn + c, bk, bn, live, acc);
      if (live) {
        const float inv = inv_norm[(size_t)t * bn + c];
        const float w = denorm[(size_t)t * bn + c];
        const float vd = v_decr[t];
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float q = __fmul_rn(__fmul_rn(__double2float_rn(acc[r]), e.v_read), inv);
          part[r] = __fadd_rn(part[r], tile_term(q, vd, inv, w, m0 + r, c, t, e));
        }
      }
    }
#pragma unroll
    for (int r = 0; r < BM; ++r) total[r] = __fadd_rn(total[r], part[r]);
  }
  if (live) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
      if (m0 + r < M) out[(size_t)(m0 + r) * out_ld + (size_t)cb * bn + c] = total[r];
  }
}

template <int BM>
cudaError_t launch(const float* x, int M, int K, const float* gd,
                   const float* inv_norm, const float* denorm,
                   const float* v_decr, const int* row_block,
                   const int* run_start, const int* col_run_start,
                   const int* col_runs, int n_col_blocks, int bk, int bn,
                   float* out, const Epilogue& e, cudaStream_t stream) {
  const int n_sub = (bn + kThreads - 1) / kThreads;
  const dim3 grid((M + BM - 1) / BM, n_col_blocks * n_sub);
  cim_mvm_scheduled_kernel<BM><<<grid, kThreads, 0, stream>>>(
      x, M, K, gd, inv_norm, denorm, v_decr, row_block, run_start,
      col_run_start, col_runs, bk, bn, n_sub, out, n_col_blocks * bn, e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int cim_mvm_scheduled_launch(const float* x, int M, int K, const float* gd,
                             const float* inv_norm, const float* denorm,
                             const float* v_decr, const int* row_block,
                             const int* run_start, const int* col_run_start,
                             const int* col_runs, int n_col_blocks, int bk,
                             int bn, float* out, const cim::Epilogue* e,
                             int bm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 4:  return launch<4>(x, M, K, gd, inv_norm, denorm, v_decr, row_block, run_start, col_run_start, col_runs, n_col_blocks, bk, bn, out, *e, s);
    case 32: return launch<32>(x, M, K, gd, inv_norm, denorm, v_decr, row_block, run_start, col_run_start, col_runs, n_col_blocks, bk, bn, out, *e, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Static shared memory of the instantiation for `bm` rows (-1 on error).
int cim_mvm_scheduled_shared_bytes(int bm) {
  switch (bm) {
    case 4:  return cim::static_shared_bytes(cim_mvm_scheduled_kernel<4>);
    case 32: return cim::static_shared_bytes(cim_mvm_scheduled_kernel<32>);
    default: return -1;
  }
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

// Packed whole-layer NeuRRAM CIM MVM for Hopper (sm_90a).
//
// Replaces repro/kernels/cim_mvm/kernel.py::cim_mvm_packed_pallas (the
// Pallas TPU kernel `_cim_packed_kernel` with its `_epilogue`,
// `_acc_weight` and `_pwl_tanh`): a single-pass tile plan of one layer,
//   q      = x[:, row_block[t]] @ gd_tiles[t] * v_read * inv_norm[t]
//   counts = ADC epilogue of q (charge-decrement rounding + activation)
//   out[:, col_block[t]] += counts * weight[t]      in slot order.
//
// What bounds it: at decode (M <= 16 rows) every gd_tiles element is read
// once and used for M multiply-adds, so the kernel is bound by the bytes
// of gd_tiles (one full-width gemma2-9b layer holds 793 MB of them). At
// prefill (M = 256) each element feeds 256 multiply-adds and the bound is
// the card's FP64 rate (no TF32: the counts round at .5 boundaries).
//
// Two routes, picked by the wrapper from M (kernel.py `split_route`):
//   * M <= 16, the split route (cim_split.cuh, `_split_launch` below): one
//     block per tile streams it through shared memory with bulk copies and
//     writes its terms counts * weight; a second kernel folds each column
//     block's terms in slot order. All 132 SMs pull tiles at once, where a
//     walk block per column block left most of the card idle at decode.
//   * M > 16, the walk (this file's kernel, unchanged since it was first
//     written), simple and right first:
//   - grid (row blocks of BM = 32 rows, output column blocks x column
//     sub-blocks of 128): a block owns BM x 128 outputs of one column block
//     and loops over that block's tiles [col_start[j], col_start[j+1]) in
//     slot order, the reference's accumulation order. The sum stays in
//     registers and is written once: no zero-init pass, no atomics, no
//     reduction across blocks. (A BM = 4 instantiation serves M <= 4.)
//   - one thread per output column; the tile dot (cim_epilogue.cuh
//     `fwd_tile_dot`) stages the x chunk in shared memory ([k][BM + 2]
//     doubles: broadcast 16-byte reads, padded against bank conflicts on
//     the transposing store) and reads gd straight from global memory.
// Both routes:
//   * the dot is EXACT in FP64 (see `fwd_tile_dot`), so its one rounding
//     to f32 is the correctly rounded dot and the plain version (an FP64
//     batched matmul) agrees bit for bit.
//   * the epilogue and `out += counts * weight` follow the reference
//     operation by operation (cim_epilogue.cuh `tile_term`).
//   * ragged rows (M not a multiple of BM) and ragged columns are masked,
//     not padded.
// Shared memory per walk block: kChunk * (BM + 2) * 8 bytes, at most 34,816
// (BM = 32): static, under the 48 KB default. The split route's term block
// takes dynamic shared memory (cim_split.cuh).
#include "cim_epilogue.cuh"
#include "cim_split.cuh"

namespace {

using namespace cim;

template <int BM>
__global__ void __launch_bounds__(kThreads)
cim_mvm_packed_kernel(const float* __restrict__ x, int M, int K,
                      const float* __restrict__ gd,
                      const float* __restrict__ inv_norm,
                      const float* __restrict__ denorm,
                      const float* __restrict__ v_decr,
                      const int* __restrict__ row_block,
                      const int* __restrict__ col_start,
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

  const int t_end = col_start[cb + 1];
  for (int t = col_start[cb]; t < t_end; ++t) {
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
        total[r] = __fadd_rn(total[r], tile_term(q, vd, inv, w, m0 + r, c, t, e));
      }
    }
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
                   const int* col_start, int n_col_blocks, int bk, int bn,
                   float* out, const Epilogue& e, cudaStream_t stream) {
  const int n_sub = (bn + kThreads - 1) / kThreads;
  const dim3 grid((M + BM - 1) / BM, n_col_blocks * n_sub);
  cim_mvm_packed_kernel<BM><<<grid, kThreads, 0, stream>>>(
      x, M, K, gd, inv_norm, denorm, v_decr, row_block, col_start, bk, bn,
      n_sub, out, n_col_blocks * bn, e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int cim_mvm_packed_launch(const float* x, int M, int K, const float* gd,
                          const float* inv_norm, const float* denorm,
                          const float* v_decr, const int* row_block,
                          const int* col_start, int n_col_blocks, int bk,
                          int bn, float* out, const cim::Epilogue* e, int bm,
                          void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 4:  return launch<4>(x, M, K, gd, inv_norm, denorm, v_decr, row_block, col_start, n_col_blocks, bk, bn, out, *e, s);
    case 32: return launch<32>(x, M, K, gd, inv_norm, denorm, v_decr, row_block, col_start, n_col_blocks, bk, bn, out, *e, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Static shared memory of the instantiation for `bm` rows (-1 on error).
int cim_mvm_packed_shared_bytes(int bm) {
  switch (bm) {
    case 4:  return cim::static_shared_bytes(cim_mvm_packed_kernel<4>);
    case 32: return cim::static_shared_bytes(cim_mvm_packed_kernel<32>);
    default: return -1;
  }
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

// Single-matrix NeuRRAM CIM MVM for Hopper (sm_90a).
//
// Replaces repro/kernels/cim_mvm/kernel.py::cim_mvm_pallas (the Pallas TPU
// kernel `_cim_kernel` with its `_epilogue`): one programmed matrix,
//   acc    = x @ gd                        over all K rows
//   q      = acc * v_read * inv_norm[n]    (f32, in this order)
//   out    = ADC epilogue of q (charge-decrement rounding + activation:
//            none, relu, tanh, sigmoid, identity, or the stochastic neuron)
// with x (M, K) integer-valued f32, gd = G+ - G- (K, N) f32, a scalar
// v_decr (device pointer) and one write per output.
//
// What bounds it: on the per-matrix path (im2col'd convolutions of the
// 7-layer CNN and ResNet-20, K <= 577, N <= 64) every x element is used by
// N <= 64 multiply-adds, so the kernel is bound by the bytes of x (a
// ResNet-20 stem-stage launch at batch 256 reads 152 MB of it).
//
// What the design does about it (simple and right first):
//   * grid (row blocks of BM, column blocks of 128): one thread per output
//     column; BM = 4 for M <= 4 and 32 above. A block's x rows are staged
//     through shared memory in 128-column chunks (cim_epilogue.cuh
//     `fwd_tile_dot` over the whole K), and each gd element is read
//     straight from global memory by its one thread. With N <= 64 one
//     column block covers the matrix, so x is read once; most of a block's
//     128 threads then have no column and only stage x (not tuned here).
//   * the dot sums in FP64, which is exact: x holds integers (|x| <= 127)
//     and every conductance >= 1 uS puts gd on the 2^-23 grid (the
//     verifier's per-matrix `exact-dot`), so the one rounding to f32 is
//     the correctly rounded dot and the plain version (an FP64 matmul)
//     agrees bit for bit. The reference's f32 sum over 256-row blocks may
//     differ only where |q| / v_decr lies within rounding of a .5 boundary.
//   * the stochastic neuron hashes at the reference's block-local
//     coordinates (row % bm_ref, col % bn_ref) with salts (seed,
//     row / bm_ref, col / bn_ref), (bm_ref, bn_ref) the reference's block.
//   * ragged rows and columns are masked, not padded.
// Shared memory per block: kChunk * (BM + 2) * 8 bytes, at most 34,816.
#include "cim_epilogue.cuh"

namespace {

using namespace cim;

template <int BM>
__global__ void __launch_bounds__(kThreads)
cim_mvm_kernel(const float* __restrict__ x, int M, int K,
               const float* __restrict__ gd, int N,
               const float* __restrict__ inv_norm,
               const float* __restrict__ v_decr, int bn_ref,
               float* __restrict__ out, Epilogue e) {
  __shared__ __align__(16) double xs[kChunk][BM + 2];
  const int m0 = blockIdx.x * BM;
  const int c = blockIdx.y * kThreads + threadIdx.x;
  const bool live = c < N;

  double acc[BM];
  fwd_tile_dot<BM>(xs, x, M, K, m0, 0, gd + (live ? c : 0), K, N, live, acc);
  if (!live) return;
  const float inv = inv_norm[c];
  const float vd = *v_decr;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int row = m0 + r;
    if (row < M) {
      const float q = __fmul_rn(__fmul_rn(__double2float_rn(acc[r]), e.v_read), inv);
      out[(size_t)row * N + c] = e.act == kStochastic
          ? stochastic_bit(q, vd, (uint32_t)(row % e.bm_ref),
                           (uint32_t)(c % bn_ref), (uint32_t)(row / e.bm_ref),
                           (uint32_t)(c / bn_ref), e)
          : adc(q, vd, e);
    }
  }
}

template <int BM>
cudaError_t launch(const float* x, int M, int K, const float* gd, int N,
                   const float* inv_norm, const float* v_decr, int bn_ref,
                   float* out, const Epilogue& e, cudaStream_t stream) {
  const dim3 grid((M + BM - 1) / BM, (N + kThreads - 1) / kThreads);
  cim_mvm_kernel<BM><<<grid, kThreads, 0, stream>>>(
      x, M, K, gd, N, inv_norm, v_decr, bn_ref, out, e);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int cim_mvm_launch(const float* x, int M, int K, const float* gd, int N,
                   const float* inv_norm, const float* v_decr, int bn_ref,
                   float* out, const cim::Epilogue* e, int bm, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 4:  return launch<4>(x, M, K, gd, N, inv_norm, v_decr, bn_ref, out, *e, s);
    case 32: return launch<32>(x, M, K, gd, N, inv_norm, v_decr, bn_ref, out, *e, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Static shared memory of the instantiation for `bm` rows (-1 on error).
int cim_mvm_shared_bytes(int bm) {
  switch (bm) {
    case 4:  return cim::static_shared_bytes(cim_mvm_kernel<4>);
    case 32: return cim::static_shared_bytes(cim_mvm_kernel<32>);
    default: return -1;
  }
}

}  // extern "C"

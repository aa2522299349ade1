// Packed whole-layer NeuRRAM CIM MVM for Hopper (sm_90a).
//
// Replaces repro/kernels/cim_mvm/kernel.py::cim_mvm_packed_pallas (the
// Pallas TPU kernel `_cim_packed_kernel` with its `_epilogue`,
// `_acc_weight` and `_pwl_tanh`): a single-pass tile plan of one layer,
//   q      = x[:, row_block[t]] @ gd_tiles[t] * v_read * inv_norm[t]
//   counts = ADC epilogue of q (charge-decrement rounding + activation)
//   out[:, col_block[t]] += counts * denorm[t]      in slot order.
//
// What bounds it: at decode (M = 4 rows) every gd_tiles element is read
// once and used for M multiply-adds, so the kernel is bound by the bytes
// of gd_tiles (one full-width gemma2-9b layer holds 793 MB of them). At
// prefill (M = 256) each element feeds 256 multiply-adds and the bound is
// the card's FP64 rate (no TF32: the counts round at .5 boundaries).
//
// What the design does about it (simple and right first):
//   * grid (row blocks of BM, output column blocks x column sub-blocks of
//     128), BM = 4 for M <= 4 (decode) and 32 above: a block owns BM x 128 outputs of one column block and loops
//     over that block's tiles [col_start[j], col_start[j+1]) in slot
//     order, the reference's accumulation order. The sum stays in
//     registers and is written once: no zero-init pass, no atomics, no
//     reduction across blocks.
//   * one thread per output column: neighbouring threads read neighbouring
//     gd elements (coalesced), and each gd element is used BM times from a
//     register. Each element is used by exactly one thread, so gd is read
//     straight from global memory with the k loop unrolled to keep several
//     loads in flight; the x chunk, which every thread of the block reads,
//     is staged in shared memory ([k][BM + 2] doubles: broadcast 16-byte
//     reads, padded against bank conflicts on the transposing store).
//   * the dot is EXACT: x holds integers (|x| <= 127) and G+ - G- of
//     conductances >= g_min = 1 uS is a multiple of 2^-23 below 2^6, so
//     every product and partial sum of a tile (<= 256 rows) is a multiple
//     of 2^-23 below 2^21 and fits a double. The chip verifier
//     (core/verify.py, invariant `exact-dot`) checks this of every packed
//     plan before it is served. The FP64 sum is therefore the
//     same in any order, and its one rounding to f32 is the correctly
//     rounded dot: the plain version (an FP64 batched matmul) agrees bit
//     for bit, where two f32 summation orders would disagree near the .5
//     count boundaries.
//   * the rest follows the reference exactly: the epilogue and `out +=
//     counts * denorm` use __fmul_rn / __fadd_rn / __fdiv_rn, so no
//     multiply-add contracts and the division is IEEE; sign is (q > 0) -
//     (q < 0), as jnp.sign.
//   * ragged rows (M not a multiple of BM) and ragged columns (bn not a
//     multiple of 128) are masked, not padded.
// Shared memory per block: K_CHUNK * (BM + 2) * 8 bytes, at most 34,816
// (BM = 32): static, under the 48 KB default.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // output columns per block (one per thread)
constexpr int kChunk = 128;    // x columns staged per shared-memory pass

enum Activation { kNone = 0, kRelu = 1, kTanh = 2, kSigmoid = 3,
                  kIdentity = 4 };

struct Epilogue {
  int act;
  float v_read, n_max, n_max4;
  float k0, k1, k2, st0, st1, st2;  // PWL tanh knots (f32, as the reference)
};

__device__ __forceinline__ float adc(float q, float vd, const Epilogue& e) {
  if (e.act == kIdentity) return q;
  const float sign = (float)((q > 0.f) - (q < 0.f));
  const float steps = floorf(__fadd_rn(__fdiv_rn(fabsf(q), vd), 0.5f));
  if (e.act == kRelu) return __fmul_rn(fminf(steps, e.n_max), sign > 0.f ? 1.f : 0.f);
  if (e.act == kTanh || e.act == kSigmoid) {
    const float s = fminf(steps, e.n_max4);
    float o;
    if (s <= e.st0)      o = s;
    else if (s <= e.st1) o = __fadd_rn(e.k0, __fmul_rn(__fsub_rn(s, e.st0), 0.5f));
    else if (s <= e.st2) o = __fadd_rn(e.k1, __fdiv_rn(__fsub_rn(s, e.st1), 3.0f));
    else                 o = __fadd_rn(e.k2, __fmul_rn(__fsub_rn(s, e.st2), 0.25f));
    float out = __fmul_rn(sign, fminf(floorf(o), e.n_max));
    if (e.act == kSigmoid) out = floorf(__fmul_rn(__fadd_rn(out, e.n_max), 0.5f));
    return out;
  }
  return __fmul_rn(sign, fminf(steps, e.n_max));
}

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
    const int kbase = row_block[t] * bk;
    const float* g = gd + (size_t)t * bk * bn + c;
    double acc[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = 0.0;

    for (int k0 = 0; k0 < bk; k0 += kChunk) {
      const int kc = min(kChunk, bk - k0);
      __syncthreads();  // the previous chunk is fully consumed
      for (int i = threadIdx.x; i < BM * kChunk; i += kThreads) {
        const int r = i / kChunk, k = i % kChunk;
        const int row = m0 + r, col = kbase + k0 + k;
        xs[k][r] = (row < M && k < kc && col < K) ? (double)x[(size_t)row * K + col] : 0.0;
      }
      __syncthreads();
      if (live) {
#pragma unroll 8
        for (int k = 0; k < kc; ++k) {
          const double gv = (double)__ldg(g + (size_t)(k0 + k) * bn);
#pragma unroll
          for (int r = 0; r < BM; r += 2) {
            const double2 xv = *reinterpret_cast<const double2*>(&xs[k][r]);
            acc[r] = fma(xv.x, gv, acc[r]);
            acc[r + 1] = fma(xv.y, gv, acc[r + 1]);
          }
        }
      }
    }
    if (live) {
      const float inv = inv_norm[(size_t)t * bn + c];
      const float w = denorm[(size_t)t * bn + c];
      const float vd = v_decr[t];
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float q = __fmul_rn(__fmul_rn(__double2float_rn(acc[r]), e.v_read), inv);
        total[r] = __fadd_rn(total[r], __fmul_rn(adc(q, vd, e), w));
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

template <int BM>
int shared_bytes() {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, cim_mvm_packed_kernel<BM>) != cudaSuccess)
    return -1;
  return (int)attr.sharedSizeBytes;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int cim_mvm_packed_launch(const float* x, int M, int K, const float* gd,
                          const float* inv_norm, const float* denorm,
                          const float* v_decr, const int* row_block,
                          const int* col_start, int n_col_blocks, int bk,
                          int bn, float* out, int activation, float v_read,
                          float n_max, float n_max4, float k0, float k1,
                          float k2, float st0, float st1, float st2, int bm,
                          void* stream) {
  const Epilogue e{activation, v_read, n_max, n_max4, k0, k1, k2, st0, st1, st2};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 4:  return launch<4>(x, M, K, gd, inv_norm, denorm, v_decr, row_block, col_start, n_col_blocks, bk, bn, out, e, s);
    case 32: return launch<32>(x, M, K, gd, inv_norm, denorm, v_decr, row_block, col_start, n_col_blocks, bk, bn, out, e, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Static shared memory of the instantiation for `bm` rows (-1 on error).
int cim_mvm_packed_shared_bytes(int bm) {
  switch (bm) {
    case 4:  return shared_bytes<4>();
    case 32: return shared_bytes<32>();
    default: return -1;
  }
}

}  // extern "C"

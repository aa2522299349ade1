// Noise-injection training matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/noisy_matmul/kernel.py::noisy_matmul_pallas (the
// Pallas TPU kernel `_kernel`):
//   y = x @ (w + sigma_abs * eps),   eps = hash_normal at the weight
// element's reference coordinates: the reference draws
// hash_normal((bk_ref, bn_ref), seed, k, j) per (bk_ref, bn_ref) weight
// tile, so element (kk, n) takes row kk % bk_ref, column n % bn_ref and
// salts (seed, kk / bk_ref, n / bn_ref). The noise depends on (seed,
// element) only: one noisy weight matrix per step, whichever rows of x
// consume it.
//
// What bounds it: a GEMM of 2*M*K*N f32 operations (no TF32: FP32 FMAs on
// the CUDA cores, 67 TFLOP/s on an H100 SXM) plus the noise, a hash pair,
// logf, sqrtf and cosf per weight element per CUDA block that loads it.
//
// What the design does about it (simple and right first):
//   * classic shared-memory tiling: a block of 256 threads owns a 128 x 64
//     output tile, loops over K in 16-deep chunks staged in shared memory,
//     each thread accumulating an 8 x 4 register micro-tile with fmaf in
//     K order.
//   * the noise is added as each weight tile is loaded into shared memory
//     (w + sigma * eps, two roundings as the reference): nothing of eps is
//     written to or read from global memory, so device-memory traffic stays
//     at the clean-weight level; each weight element's eps is drawn once
//     per block row that loads it (M / 128 times).
//   * sigma_abs is read from device memory (no host sync for max|w|).
//   * ragged edges are masked, not padded.
// Shared memory per block: 16 * (128 + 4) * 4 + 16 * (64 + 4) * 4 = 12,800
// bytes, static.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_prng.cuh"

namespace {

constexpr int kBM = 128, kBN = 64, kBK = 16, kThreads = 256;
constexpr int kTM = kBM / 16, kTN = kBN / 16;  // per-thread micro-tile

__global__ void __launch_bounds__(kThreads)
noisy_matmul_kernel(const float* __restrict__ x, const float* __restrict__ w,
                    int M, int K, int N, const float* __restrict__ sigma,
                    uint32_t seed, int bk_ref, int bn_ref,
                    float* __restrict__ out) {
  __shared__ float xs[kBK][kBM + 4];   // x tile, transposed: xs[k][m]
  __shared__ float ws[kBK][kBN + 4];   // noisy weight tile: ws[k][n]
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const float sig = *sigma;

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * kBK; i += kThreads) {
      const int r = i / kBK, k = i % kBK;
      const int row = m0 + r, col = k0 + k;
      xs[k][r] = (row < M && col < K) ? x[(size_t)row * K + col] : 0.f;
    }
    for (int i = threadIdx.x; i < kBK * kBN; i += kThreads) {
      const int k = i / kBN, c = i % kBN;
      const int kk = k0 + k, n = n0 + c;
      float v = 0.f;
      if (kk < K && n < N) {
        const float eps = prng::normal3(
            (uint32_t)(kk % bk_ref), (uint32_t)(n % bn_ref), seed,
            (uint32_t)(kk / bk_ref), (uint32_t)(n / bn_ref));
        v = __fadd_rn(w[(size_t)kk * N + n], __fmul_rn(sig, eps));
      }
      ws[k][c] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kBK; ++k) {
      float a[kTM], b[kTN];
#pragma unroll
      for (int i = 0; i < kTM; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kTN; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = m0 + ty + 16 * i;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (row < M && col < N) out[(size_t)row * N + col] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int noisy_matmul_launch(const float* x, const float* w, int M, int K, int N,
                        const float* sigma, unsigned int seed, int bk_ref,
                        int bn_ref, float* out, void* stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  noisy_matmul_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, M, K, N, sigma, seed, bk_ref, bn_ref, out);
  return (int)cudaGetLastError();
}

// Static shared memory of the kernel (-1 on error).
int noisy_matmul_shared_bytes(void) {
  cudaFuncAttributes attr;
  if (cudaFuncGetAttributes(&attr, noisy_matmul_kernel) != cudaSuccess) return -1;
  return (int)attr.sharedSizeBytes;
}

}  // extern "C"

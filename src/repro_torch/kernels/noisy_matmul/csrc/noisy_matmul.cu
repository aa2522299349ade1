// Noise-injection training matmul for Hopper (sm_90a).
//
// Replaces repro/kernels/noisy_matmul/kernel.py::noisy_matmul_pallas (the
// Pallas TPU kernel `_kernel`):
//   y = x @ (w + sigma_abs * eps),   eps = hash_normal at the weight
// element's reference coordinates: the reference draws
// hash_normal((bk_ref, bn_ref), seed, k, j) per (bk_ref, bn_ref) weight
// tile, so element (kk, n) takes row kk % bk_ref, column n % bn_ref and
// salts (seed, kk / bk_ref, n / bn_ref). The noise depends on (seed,
// element) only: one noisy weight matrix per call, whichever rows of x
// consume it.
//
// What bounds it: a GEMM of 2*M*K*N f32 operations (no TF32: FP32 FMAs on
// the CUDA cores, 67 TFLOP/s on an H100 SXM; 3.14 ms for a gemma2-9b w_g
// in training, 2048 x 3584 x 14336) plus one draw per weight element.
//
// Two kernels, launched back to back on one stream by the wrapper
// (noisy_weight_launch, then noisy_sgemm_launch):
//   * noisy_weight: one elementwise pass draws each weight element's eps
//     exactly once and writes w' = w + sigma * eps (two roundings,
//     __fmul_rn then __fadd_rn, as the reference) into a scratch the
//     wrapper allocates, zero-padded to (Kp, Np): Kp a multiple of the
//     GEMM's k-tile, Np of its column tile, so the GEMM's loads of w' are
//     aligned and never masked. sigma_abs is read on the device (no host
//     sync for max|w|).
//     The TPU kernel draws eps in its pipeline, so that eps never reaches
//     HBM. On this card an IEEE Box-Muller draw (prng::normal3: six
//     integer mixes, logf, sqrtf, cosf, about 150 instructions) costs
//     more than the bytes it saves: a fused draw is paid once per row
//     block of x that loads the weight tile (M / 128 = 16 times at w_g),
//     the two passes pay one draw plus one write and one read of w' (at
//     w_g 205 MB each way, about 0.12 ms at 3.35 TB/s).
//   * noisy_sgemm: x @ w' in FP32 on the CUDA cores, the register-blocked
//     design: a block of warps owns a BM x BN output tile, each warp 32 x
//     8 TN, each lane an 8 x TN micro-tile (two 4-row blocks 16 apart by
//     TN / 4 4-column blocks 32 apart), so every k step reads 2 float4 of
//     x and TN / 4 float4 of w' from shared memory for 8 TN FMAs, without
//     bank conflicts. K runs in tiles of BK through a ring of ST
//     shared-memory stages filled by cp.async, ST - 1 tiles in flight
//     while one is read, one __syncthreads per tile. x's tile is stored
//     k-major ([k][m], rows padded to BM + 4 floats), so the micro-tile
//     reads are float4; its rows need not sit on the 16-byte grid (cnn7
//     conv5's K = 577 rows are 2,308 bytes), so each x element comes by
//     its own 4-byte cp.async, zero-filled (src-size 0) past M and K. w'
//     comes by 16-byte cp.async. Each output sums its k terms in k order
//     with fmaf (another order than the plain version's: NOISY_TOL).
//     Grid: the row tiles of one column tile consecutive, so the blocks
//     that share a strip of w' run together. Two tilings (kernel.py
//     `sgemm_geometry` takes the larger where its grid fills the card):
//     128 x 256 with k-tiles of 32 in 2 stages, 8 x 16 per lane, one
//     256-thread block per SM (a gemma2-9b w_g: 896 blocks; of the
//     tilings tried on the card it took the least time: longer k-tiles
//     mean fewer barriers, 8 x 16 fewer shared-memory reads per FMA), and
//     64 x 64 with k-tiles of 8 in 4 stages, 8 x 8 per lane, 64 threads
//     and at least 2 blocks per SM in the register budget (cnn7 conv5,
//     N = 64: 196 blocks). No atomics: two calls return
//     equal tensors.
// Shared memory per SGEMM block (dynamic): ST * BK * ((BM + 4) + BN) * 4
// bytes: 99,328 at 128 x 256, 16,896 at 64 x 64.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_prng.cuh"

namespace {

constexpr int kWeightThreads = 256;
constexpr int kTiles = 2;       // SGEMM tilings (kernel.py SGEMM_TILES)
// rows, columns, k per tile of each tiling: 128 x 256 (k-tiles of 32, 2
// stages, 8 x 16 per lane, 256 threads) and 64 x 64 (k-tiles of 8, 4
// stages, 8 x 8 per lane, 64 threads)
constexpr int kTile[kTiles][3] = {{128, 256, 32}, {64, 64, 8}};

// w'[kk][n] = w[kk][n] + sigma * eps(kk, n) for kk < K, n < N; 0 in the
// padding. Four consecutive columns per thread (Np % 4 == 0), one row per
// grid row. The reference coordinates' divisions are taken once per
// thread (a row's are the block's), the four columns' by stepping.
__global__ void __launch_bounds__(kWeightThreads)
noisy_weight_kernel(const float* __restrict__ w, int K, int N,
                    const float* __restrict__ sigma, uint32_t seed, int bk_ref,
                    int bn_ref, float* __restrict__ wn, int Np) {
  const int kk = blockIdx.y;
  const int n0 = 4 * (blockIdx.x * kWeightThreads + threadIdx.x);
  if (n0 >= Np) return;
  const float sig = *sigma;
  const uint32_t k_in = (uint32_t)(kk % bk_ref), k_blk = (uint32_t)(kk / bk_ref);
  int n_blk = n0 / bn_ref, n_in = n0 - n_blk * bn_ref;
  float v[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int n = n0 + u;
    v[u] = 0.f;
    if (kk < K && n < N) {
      const float eps = prng::normal3(k_in, (uint32_t)n_in, seed, k_blk, (uint32_t)n_blk);
      v[u] = __fadd_rn(w[(size_t)kk * N + n], __fmul_rn(sig, eps));
    }
    if (++n_in == bn_ref) {
      n_in = 0;
      ++n_blk;
    }
  }
  *reinterpret_cast<float4*>(wn + (size_t)kk * Np + n0) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from src, or zeros (src-size 0: nothing is read).
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(dst), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// A tiling of the SGEMM: a BM x BN block tile, k-tiles of BK through ST
// stages, an 8 x TN micro-tile per lane (warps of 32 x 8 TN), at least
// MINB blocks per SM (the register budget).
template <int BM, int BN, int BK, int ST, int TN, int MINB>
struct Sgemm {
  static constexpr int kWarpsN = BN / (8 * TN);
  static constexpr int kThreads = (BM / 32) * kWarpsN * 32;
  static constexpr int kAPitch = BM + 4;   // floats per staged x row (k-major)
  static constexpr int kStageFloats = BK * (kAPitch + BN);
  static constexpr int kSharedBytes = ST * kStageFloats * 4;
};

// out (M, N) = x (M, K) @ wn (Kp, Np), wn zero-padded.
template <int BM, int BN, int BK, int ST, int TN, int MINB>
__global__ void __launch_bounds__(Sgemm<BM, BN, BK, ST, TN, MINB>::kThreads, MINB)
noisy_sgemm(const float* __restrict__ x, int M, int K,
            const float* __restrict__ wn, int Kp, int Np,
            float* __restrict__ out, int N) {
  using S = Sgemm<BM, BN, BK, ST, TN, MINB>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int wm = (warp / S::kWarpsN) * 32, wn0 = (warp % S::kWarpsN) * (8 * TN);
  const int lm = lane >> 3, ln = lane & 7;
  const int nk = Kp / BK;

  // k tile kt into stage st: x's BM x BK block transposed into [k][m], 4
  // bytes a copy; w''s BK x BN block, 16 bytes a copy
  auto load = [&](int st, int kt) {
    float* as = smem + st * S::kStageFloats;
    float* bs = as + BK * S::kAPitch;
    const int k0 = kt * BK;
#pragma unroll
    for (int e = tid; e < BM * BK; e += S::kThreads) {
      const int r = e / BK, kq = e % BK;
      const int row = m0 + r, col = k0 + kq;
      const bool ok = row < M && col < K;
      cp_async4(smem_u32(as + kq * S::kAPitch + r),
                ok ? x + (size_t)row * K + col : x, ok);
    }
#pragma unroll
    for (int e = tid; e < BK * BN / 4; e += S::kThreads) {
      const int kq = e / (BN / 4), c4 = e % (BN / 4);
      cp_async16(smem_u32(bs + kq * BN + 4 * c4),
                 wn + (size_t)(k0 + kq) * Np + n0 + 4 * c4);
    }
  };

  float acc[8][TN];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < ST - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<ST - 2>();            // tile kt has landed (this thread's copies)
    __syncthreads();                    // ... everyone's; stage kt - 1 is free
    if (kt + ST - 1 < nk) load((kt + ST - 1) % ST, kt + ST - 1);
    cp_async_commit();
    const float* as = smem + (kt % ST) * S::kStageFloats;
    const float* bs = as + BK * S::kAPitch;
#pragma unroll
    for (int k = 0; k < BK; ++k) {
      float a[8], b[TN];
      const float4 a0 = *reinterpret_cast<const float4*>(as + k * S::kAPitch + wm + 4 * lm);
      const float4 a1 = *reinterpret_cast<const float4*>(as + k * S::kAPitch + wm + 16 + 4 * lm);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
      for (int h = 0; h < TN / 4; ++h) {
        const float4 bv = *reinterpret_cast<const float4*>(bs + k * BN + wn0 + 32 * h + 4 * ln);
        b[4 * h] = bv.x; b[4 * h + 1] = bv.y; b[4 * h + 2] = bv.z; b[4 * h + 3] = bv.w;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  const bool vec = (N & 3) == 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = m0 + wm + 16 * (i >> 2) + 4 * lm + (i & 3);
    if (row >= M) continue;
    float* orow = out + (size_t)row * N;
#pragma unroll
    for (int h = 0; h < TN / 4; ++h) {
      const int col = n0 + wn0 + 32 * h + 4 * ln;
      if (vec && col < N) {
        *reinterpret_cast<float4*>(orow + col) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else if (!vec) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (col + j < N) orow[col + j] = acc[i][4 * h + j];
      }
    }
  }
}

// The dynamic shared memory each tiling's kernel may request so far.
static int sgemm_smem_allowed[kTiles] = {48 * 1024, 48 * 1024};

template <int T, int BM, int BN, int BK, int ST, int TN, int MINB>
int sgemm_launch(const float* x, int M, int K, const float* wn, int Kp, int Np,
                 float* out, int N, cudaStream_t stream) {
  using S = Sgemm<BM, BN, BK, ST, TN, MINB>;
  if (S::kSharedBytes > sgemm_smem_allowed[T]) {
    const cudaError_t err = cudaFuncSetAttribute(
        noisy_sgemm<BM, BN, BK, ST, TN, MINB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        S::kSharedBytes);
    if (err != cudaSuccess) return (int)err;
    sgemm_smem_allowed[T] = S::kSharedBytes;
  }
  const dim3 grid((M + BM - 1) / BM, Np / BN);
  noisy_sgemm<BM, BN, BK, ST, TN, MINB><<<grid, S::kThreads, S::kSharedBytes, stream>>>(
      x, M, K, wn, Kp, Np, out, N);
  return (int)cudaGetLastError();
}

bool valid(int M, int K, int N, const float* wn, int Kp, int Np, int tile) {
  return tile >= 0 && tile < kTiles && M >= 1 && K >= 1 && N >= 1 &&
         Kp >= K && Kp % kTile[tile][2] == 0 && Kp <= 65535 &&   // a grid row per k
         Np >= N && Np % kTile[tile][1] == 0 && Np / kTile[tile][1] <= 65535 &&
         (reinterpret_cast<uintptr_t>(wn) & 15) == 0;
}

int weight_launch(const float* w, int K, int N, const float* sigma, unsigned int seed,
                  int bk_ref, int bn_ref, float* wn, int Kp, int Np, cudaStream_t stream) {
  const dim3 grid((Np / 4 + kWeightThreads - 1) / kWeightThreads, Kp);
  noisy_weight_kernel<<<grid, kWeightThreads, 0, stream>>>(w, K, N, sigma, seed, bk_ref,
                                                           bn_ref, wn, Np);
  return (int)cudaGetLastError();
}

int gemm_launch(const float* x, int M, int K, const float* wn, int Kp, int Np, int tile,
                float* out, int N, cudaStream_t stream) {
  switch (tile) {
    case 0: return sgemm_launch<0, 128, 256, 32, 2, 16, 1>(x, M, K, wn, Kp, Np, out, N, stream);
    case 1: return sgemm_launch<1, 64, 64, 8, 4, 8, 2>(x, M, K, wn, Kp, Np, out, N, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The weight pass on `stream`: w' into wn (Kp, Np), padded for SGEMM
// tiling `tile`. Returns a CUDA error code (0 = launched).
int noisy_weight_launch(const float* w, int K, int N, const float* sigma,
                        unsigned int seed, int bk_ref, int bn_ref, float* wn,
                        int Kp, int Np, int tile, void* stream) {
  if (!valid(1, K, N, wn, Kp, Np, tile)) return (int)cudaErrorInvalidValue;
  return weight_launch(w, K, N, sigma, seed, bk_ref, bn_ref, wn, Kp, Np,
                       static_cast<cudaStream_t>(stream));
}

// The SGEMM on `stream` at tiling `tile`: out = x @ wn[:K, :N]. Returns
// a CUDA error code (0 = launched).
int noisy_sgemm_launch(const float* x, int M, int K, int N, const float* wn,
                       int Kp, int Np, int tile, float* out, void* stream) {
  if (!valid(M, K, N, wn, Kp, Np, tile)) return (int)cudaErrorInvalidValue;
  return gemm_launch(x, M, K, wn, Kp, Np, tile, out, N, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory the SGEMM requests at tiling `tile` (-1 for none).
int noisy_sgemm_shared_bytes(int tile) {
  switch (tile) {
    case 0: return Sgemm<128, 256, 32, 2, 16, 1>::kSharedBytes;
    case 1: return Sgemm<64, 64, 8, 4, 8, 2>::kSharedBytes;
    default: return -1;
  }
}

}  // extern "C"

// GQA / MQA attention for Hopper (sm_90a): the dense path of the port's
// `models/transformer.attention` on CUDA tensors.
//
// Replaces no Pallas kernel: the reference's attention
// (repro/models/transformer.py `attention`) is plain jnp, and so is the
// port's plain version (`transformer._dense_attention`, which the CPU
// keeps and the kernel's backward recomputes). It was added because that plain path, on the card,
// repeated each KV head to its query heads, copied K and V to float64
// and ran float64 einsums over every key of the slot, masked or not: at
// granite-20b's 48 query heads on one KV head, 16 slots of 4096 keys,
// about 56 ms of a 63 ms decode step.
//
// Arithmetic: the plain path's, step for step (C3 in ROADMAP.md: a row's
// result must not depend on the batch, since a last-bit change can move a
// 4-bit chip input by a level). Per query row and key
//   s = f32(sum_d f64(q) f64(k))   rounded once (to bf16 after f32 for
//                                  bf16 inputs, as PyTorch's .to() does)
//   s = s * scale                  (f32, then the input type)
//   s = tanh(s * (1/cap)) * cap    where softcap > 0 (PyTorch's division
//                                  by a Python scalar is a multiply by its
//                                  f32 reciprocal)
//   s = -1e30 where masked         (causal, window, the fill kv_len)
//   p = exp(s - max) / sum         in f32, two passes (not an online
//                                  softmax), then rounded to the input type
//   o = f32(sum_k f64(p) f64(v))   rounded once to the input type.
// Keys past a row's last unmasked key, and before its window, contribute
// exact zeros to all three sums, so the kernel does not visit them: a row
// attends [lo, hi) = [max(0, pos - window + 1), min(Sk, fill, pos + 1)).
// A row with no unmasked key sees -1e30 everywhere, as the plain path's
// softmax does (p = 1 / Sk over every key).
//
// What bounds it: at decode the bytes, each (slot, KV head)'s K and V up
// to its rows' last key, read once (granite's 16 x 4096 keys x 128 in
// f32: 67 MB a layer, 20 us at 3.35 TB/s); at prefill the FP64 products,
// 4 x rows x keys x D (a 256-row granite chunk over 4096 keys: 25.8 GFLOP
// a layer, 0.39 ms at 67 TFLOP/s on the tensor cores).
//
// Design: GQA-aware, one read of a KV head for its whole query group.
// The rows of (slot b, KV head g) are rep = H / Hkv heads x Sq positions
// (row r = s * rep + j, head g * rep + j); every pass tiles those rows
// against one staged copy of the head's K or V tile. Four kernels, on the
// caller's stream:
//   1. scores: per (key split t, b g, row block), the scores of the
//      split's keys that the rows attend, into an f32 scratch, and each
//      row's maximum over the split;
//   2. exp: per (b g, 8 rows), the row's maximum over the splits, e =
//      exp(s - max) in place, and the sum of e in the order PyTorch's f32
//      softmax over Sk entries sums it (one warp a row, `gqa_exp`), so p
//      is the plain path's to the bit;
//   3. values: p = e / sum rounded to the input type, and per split the
//      f64 chain over its
//      keys of p v; either written per split (f64 scratch) or, where the
//      row blocks alone fill the card, summed in split order in the block
//      and rounded (`whole`);
//   4. combine (split mode only): the per-split chains summed in split
//      order and rounded once.
// Keys split at fixed offsets of kSplit keys, the same for every shape;
// every f64 chain runs its keys (or dims) in ascending order from +0, and
// the splits are summed in split order; the softmax sum's order is a
// function of Sk; a skipped key or tile adds an exact zero. So a row's
// bits depend on its q, its keys, its range and Sk, and nothing else: not on the batch, the live slots, Sq, the chunking, the
// row blocks or which of the two modes of pass 3 ran.
// The products run on DMMA (mma.sync m16n8k4 f64, cim_dmma.cuh) where a
// KV head has kMmaRows or more rows, and otherwise on the CUDA cores as
// the DMMA's own arithmetic (`fma4`: the k-step's four fused
// multiply-adds in k order, held bit for bit against DMMA by the card
// test and `gqa_dmma_probe`), so both routes give the same bits.
// The DMMA tiles stage f32 copies of Q, K, V and p in shared memory with
// rows padded to a bank-conflict-free stride (dims + 4, keys + 4, dims +
// 8), each fragment converted to f64 as it is read; f32 tiles arrive by
// cp.async (16 bytes a copy where the rows sit on the 16-byte grid), all
// of a tile's copies in flight at once. The head dim is
// padded with zeros to DP = 32, 64, 128 or 256 (exact: fma(0, 0, c) = c).
// No atomics on global memory: two calls return equal tensors.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "../../cim_mvm/csrc/cim_dmma.cuh"

namespace {

constexpr int kSplit = 128;    // keys a split (kernel.py KEY_SPLIT)
constexpr int kMmaRows = 8;    // rows a KV head from which DMMA runs
constexpr int kScoreRows = 64; // scores on DMMA: rows a block
constexpr int kScoreKeys = 64; // ... keys a staged tile
constexpr int kValueRows = 32; // values on DMMA: rows a block
constexpr int kValueKeys = 64; // ... keys a staged tile
constexpr int kFmaKeys = 32;   // values on the CUDA cores: keys a tile
constexpr float kMasked = -1e30f;

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* out;                    // (B, Sq, H, D), contiguous
  int B, Sq, H, Hkv, D, Sk, rep, R, T;
  long long q_sb, q_ss, q_sh;   // element strides; the last dim is dense
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  const long long* q_pos;       // (B, Sq) or (Sq,) with qpos_sb = 0
  long long qpos_sb;
  const long long* kv_len;      // (B,) fills, or nullptr: kv_fill for all
  long long kv_fill;
  int causal, window;
  float scale, softcap, inv_cap;
  float* scores;                // (B Hkv, R, Sk): s, then e
  float* pmax;                  // (B Hkv, R, T)
  float* psum;                  // (B Hkv, R): the softmax sums
  int sm_stride, sm_reg, sm_nth; // PyTorch's softmax order (pass 2)
  int vec;                      // f32 rows of q, k, v on the 16-byte grid
  double* opart;                // (B Hkv, T, R, DP), split mode
};

// The keys row r of slot b attends, [lo, hi) (module comment).
__device__ __forceinline__ void row_range(const Args& a, int b, int r,
                                          int& lo, int& hi, bool& empty) {
  const long long p = a.q_pos[b * a.qpos_sb + r / a.rep];
  long long h = a.Sk;
  const long long fill = a.kv_len ? a.kv_len[b] : a.kv_fill;
  if (fill < h) h = fill;
  if (a.causal && p + 1 < h) h = p + 1;
  long long l = 0;
  if (a.window > 0 && p - a.window + 1 > l) l = p - a.window + 1;
  empty = h <= l;
  lo = empty ? 0 : static_cast<int>(l);
  hi = empty ? a.Sk : static_cast<int>(h);
}

template <typename In>
__device__ __forceinline__ float load(const void* p, long long i);
template <>
__device__ __forceinline__ float load<float>(const void* p, long long i) {
  return static_cast<const float*>(p)[i];
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const void* p,
                                                     long long i) {
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

// Asynchronous copies into shared memory (cp.async) of 4 or 16 bytes from
// src, or zeros where ok is false (src then unread); cp_wait waits for
// the thread's copies.
__device__ __forceinline__ void cp4(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 4 : 0));
}
__device__ __forceinline__ void cp16(float* dst, const float* src, bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(ok ? 16 : 0));
}
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One element of a tile into shared memory: src[i] (the input type) or
// zero; f32 by an asynchronous copy (cp_wait before reading it).
template <typename In>
__device__ __forceinline__ void put(float* dst, const void* src, long long i,
                                    bool ok) {
  if (std::is_same<In, float>::value)
    cp4(dst, static_cast<const float*>(src) + (ok ? i : 0), ok);
  else
    *dst = ok ? load<In>(src, i) : 0.f;
}

// Stages ROWS x DP of a tile into shared memory at row stride LD: row i's
// dims from element offset off(i) of `base` (off(i) < 0: no row), zeros
// past D and where there is no row. f32 rows on the 16-byte grid (a.vec)
// by 16-byte asynchronous copies, all in flight before the wait.
template <typename In, int ROWS, int DP, int LD, int THREADS, typename Off>
__device__ __forceinline__ void stage(float* dst, const void* base,
                                      const Args& a, Off off) {
  if (std::is_same<In, float>::value && a.vec) {
    constexpr int C = DP / 4;
    for (int i = threadIdx.x; i < ROWS * C; i += THREADS) {
      const int row = i / C, d = (i % C) * 4;
      const long long o = off(row);
      const bool ok = o >= 0 && d < a.D;
      cp16(dst + row * LD + d,
           static_cast<const float*>(base) + (ok ? o + d : 0), ok);
    }
    cp_wait();
    return;
  }
  for (int i = threadIdx.x; i < ROWS * DP; i += THREADS) {
    const int row = i / DP, d = i % DP;
    const long long o = off(row);
    put<In>(dst + row * LD + d, base, o + d, o >= 0 && d < a.D);
  }
  cp_wait();
}

// x rounded to the input type (a no-op in f32).
template <typename In>
__device__ __forceinline__ float round_in(float x);
template <>
__device__ __forceinline__ float round_in<float>(float x) { return x; }
template <>
__device__ __forceinline__ float round_in<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// an f64 sum rounded to the input type as PyTorch's .to() rounds it
// (through f32)
template <typename In>
__device__ __forceinline__ void store_out(void* p, long long i, double x);
template <>
__device__ __forceinline__ void store_out<float>(void* p, long long i,
                                                 double x) {
  static_cast<float*>(p)[i] = __double2float_rn(x);
}
template <>
__device__ __forceinline__ void store_out<__nv_bfloat16>(void* p,
                                                         long long i,
                                                         double x) {
  static_cast<__nv_bfloat16*>(p)[i] =
      __float2bfloat16_rn(__double2float_rn(x));
}

// A dot product's score: rounded, scaled, soft-capped (module comment).
template <typename In>
__device__ __forceinline__ float score_of(double dot, const Args& a) {
  float s = round_in<In>(__double2float_rn(dot));
  s = round_in<In>(__fmul_rn(s, a.scale));
  if (a.softcap > 0.f) {
    const float x = round_in<In>(__fmul_rn(s, a.inv_cap));
    s = round_in<In>(__fmul_rn(round_in<In>(tanhf(x)), a.softcap));
  }
  return s;
}

// One DMMA k-step for one output on the CUDA cores: c + a0 b0 + a1 b1 +
// a2 b2 + a3 b3 as fused multiply-adds in k order.
__device__ __forceinline__ double fma4(double c, double a0, double a1,
                                       double a2, double a3, double b0,
                                       double b1, double b2, double b3) {
  c = __fma_rn(a0, b0, c);
  c = __fma_rn(a1, b1, c);
  c = __fma_rn(a2, b2, c);
  return __fma_rn(a3, b3, c);
}

__device__ __forceinline__ long long q_index(const Args& a, int b, int g,
                                             int r) {
  return b * a.q_sb + (r / a.rep) * a.q_ss + (g * a.rep + r % a.rep) * a.q_sh;
}

__device__ __forceinline__ long long out_index(const Args& a, int b, int g,
                                               int r) {
  return ((static_cast<long long>(b) * a.Sq + r / a.rep) * a.H + g * a.rep +
          r % a.rep) * a.D;
}

// -1e30 at every key of split [k_begin, k_end) for the rows that see no
// unmasked key.
__device__ __forceinline__ void fill_masked(const Args& a, int bg, int r0,
                                            int n_rows, const bool* empty,
                                            int k_begin, int k_end) {
  for (int rl = 0; rl < n_rows; ++rl) {
    if (!empty[rl] || r0 + rl >= a.R) continue;
    float* s = a.scores + (static_cast<long long>(bg) * a.R + r0 + rl) * a.Sk;
    for (int key = k_begin + threadIdx.x; key < k_end; key += blockDim.x)
      s[key] = kMasked;
  }
}

// Pass 1 on DMMA: 128 threads, 4 warps of 32 rows x 32 keys over a block
// of kScoreRows rows and a staged tile of kScoreKeys keys.
template <typename In, int DP>
__global__ void __launch_bounds__(128)
gqa_scores_mma(const Args a) {
  constexpr int LD = DP + 4;
  extern __shared__ float smem[];
  float* qs = smem;                        // [kScoreRows][LD]
  float* ks = smem + kScoreRows * LD;      // [kScoreKeys][LD]
  __shared__ int s_lo[kScoreRows], s_hi[kScoreRows];
  __shared__ bool s_empty[kScoreRows];
  __shared__ float s_max[2][kScoreRows];
  __shared__ int s_union[2];
  const int t = blockIdx.x, bg = blockIdx.y, r0 = blockIdx.z * kScoreRows;
  const int b = bg / a.Hkv, g = bg % a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_begin = t * kSplit, k_end = min(a.Sk, k_begin + kSplit);
  if (tid == 0) {
    s_union[0] = k_end;
    s_union[1] = k_begin;
  }
  __syncthreads();
  if (tid < kScoreRows) {
    const int r = r0 + tid;
    int lo = 0, hi = 0;
    bool empty = false;
    if (r < a.R) row_range(a, b, r, lo, hi, empty);
    s_lo[tid] = lo;
    s_hi[tid] = hi;
    s_empty[tid] = empty;
    if (r < a.R && !empty && lo < k_end && hi > k_begin) {
      atomicMin(&s_union[0], max(lo, k_begin));
      atomicMax(&s_union[1], min(hi, k_end));
    }
  }
  __syncthreads();
  const int ulo = s_union[0], uhi = s_union[1];
  fill_masked(a, bg, r0, kScoreRows, s_empty, k_begin, k_end);
  const int wm = warp >> 1, wn = warp & 1;
  float m[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
  if (ulo < uhi) {
    stage<In, kScoreRows, DP, LD, 128>(qs, a.q, a, [&](int rl) {
      return r0 + rl < a.R ? q_index(a, b, g, r0 + rl) : -1LL;
    });
    for (int kt = k_begin; kt < k_end; kt += kScoreKeys) {
      if (kt >= uhi || kt + kScoreKeys <= ulo) continue;
      __syncthreads();
      stage<In, kScoreKeys, DP, LD, 128>(ks, a.k, a, [&](int kl) {
        const int key = kt + kl;
        return key >= ulo && key < uhi
                   ? b * a.k_sb + key * a.k_ss + g * a.k_sh : -1LL;
      });
      __syncthreads();
      double acc[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0;
#pragma unroll 4
      for (int k0 = 0; k0 < DP; k0 += 4) {
        double af[2][2], bf[4];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          const float* qr =
              qs + (wm * 32 + mt * 16 + (lane >> 2)) * LD + k0 + (lane & 3);
          af[mt][0] = qr[0];
          af[mt][1] = qr[8 * LD];
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          bf[nt] = ks[(wn * 32 + nt * 8 + (lane >> 2)) * LD + k0 + (lane & 3)];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            cim::dmma(acc[mt][nt], af[mt][0], af[mt][1], bf[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int rl = wm * 32 + mt * 16 + (lane >> 2) + (i >> 1) * 8;
            const int key = kt + wn * 32 + nt * 8 + 2 * (lane & 3) + (i & 1);
            const int r = r0 + rl;
            if (r < a.R && !s_empty[rl] && key >= s_lo[rl] && key < s_hi[rl]) {
              const float s = score_of<In>(acc[mt][nt][i], a);
              a.scores[(static_cast<long long>(bg) * a.R + r) * a.Sk + key] = s;
              m[mt][i >> 1] = fmaxf(m[mt][i >> 1], s);
            }
          }
    }
  }
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float x = m[mt][h];
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
      if ((lane & 3) == 0) s_max[wn][wm * 32 + mt * 16 + (lane >> 2) + 8 * h] = x;
    }
  __syncthreads();
  if (tid < kScoreRows && r0 + tid < a.R)
    a.pmax[(static_cast<long long>(bg) * a.R + r0 + tid) * a.T + t] =
        s_empty[tid] ? kMasked : fmaxf(s_max[0][tid], s_max[1][tid]);
}

// Pass 1 on the CUDA cores: kSplit threads, one key of the split each, NR
// rows; K staged 32 dims at a time ([key][33]: conflict-free both ways).
template <typename In, int DP, int NR>
__global__ void __launch_bounds__(kSplit)
gqa_scores_fma(const Args a) {
  __shared__ float qs[NR][DP];
  __shared__ float ks[kSplit][33];
  __shared__ int s_lo[NR], s_hi[NR];
  __shared__ bool s_empty[NR];
  __shared__ float s_max[kSplit / 32][NR];
  __shared__ int s_union[2];
  const int t = blockIdx.x, bg = blockIdx.y, r0 = blockIdx.z * NR;
  const int b = bg / a.Hkv, g = bg % a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k_begin = t * kSplit, k_end = min(a.Sk, k_begin + kSplit);
  if (tid == 0) {
    s_union[0] = k_end;
    s_union[1] = k_begin;
  }
  __syncthreads();
  if (tid < NR) {
    const int r = r0 + tid;
    int lo = 0, hi = 0;
    bool empty = false;
    if (r < a.R) row_range(a, b, r, lo, hi, empty);
    s_lo[tid] = lo;
    s_hi[tid] = hi;
    s_empty[tid] = empty;
    if (r < a.R && !empty && lo < k_end && hi > k_begin) {
      atomicMin(&s_union[0], max(lo, k_begin));
      atomicMax(&s_union[1], min(hi, k_end));
    }
  }
  __syncthreads();
  const int ulo = s_union[0], uhi = s_union[1];
  fill_masked(a, bg, r0, NR, s_empty, k_begin, k_end);
  const int key = k_begin + tid;
  float m[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) m[r] = -INFINITY;
  if (ulo < uhi) {
    for (int i = tid; i < NR * DP; i += kSplit) {
      const int rl = i / DP, d = i % DP, r = r0 + rl;
      qs[rl][d] =
          r < a.R && d < a.D ? load<In>(a.q, q_index(a, b, g, r) + d) : 0.f;
    }
    double acc[NR];
#pragma unroll
    for (int r = 0; r < NR; ++r) acc[r] = 0.0;
    for (int d0 = 0; d0 < DP; d0 += 32) {
      __syncthreads();
#pragma unroll 8
      for (int i = 0; i < 32; ++i) {
        const int kl = warp * 32 + i, kk = k_begin + kl, d = d0 + lane;
        put<In>(&ks[kl][lane], a.k, b * a.k_sb + kk * a.k_ss + g * a.k_sh + d,
                kk >= ulo && kk < uhi && d < a.D);
      }
      cp_wait();
      __syncthreads();
#pragma unroll
      for (int j = 0; j < 32; j += 4) {
        const double k0 = ks[tid][j], k1 = ks[tid][j + 1], k2 = ks[tid][j + 2],
                     k3 = ks[tid][j + 3];
#pragma unroll
        for (int r = 0; r < NR; ++r)
          acc[r] = fma4(acc[r], qs[r][d0 + j], qs[r][d0 + j + 1],
                        qs[r][d0 + j + 2], qs[r][d0 + j + 3], k0, k1, k2, k3);
      }
    }
#pragma unroll
    for (int r = 0; r < NR; ++r)
      if (r0 + r < a.R && !s_empty[r] && key >= s_lo[r] && key < s_hi[r]) {
        const float s = score_of<In>(acc[r], a);
        a.scores[(static_cast<long long>(bg) * a.R + r0 + r) * a.Sk + key] = s;
        m[r] = s;
      }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    float x = m[r];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
    if (lane == 0) s_max[warp][r] = x;
  }
  __syncthreads();
  if (tid < NR && r0 + tid < a.R) {
    float x = kMasked;
    if (!s_empty[tid]) {
      x = -INFINITY;
      for (int w = 0; w < kSplit / 32; ++w) x = fmaxf(x, s_max[w][tid]);
    }
    a.pmax[(static_cast<long long>(bg) * a.R + r0 + tid) * a.T + t] = x;
  }
}

// Pass 2: one warp a row, 8 rows a block: the row's maximum over the
// splits, e = exp(s - max) in place over its keys, and their sum in the
// order of PyTorch's f32 softmax over Sk entries, so that p = e / sum is
// the plain path's to the bit (kernel.py `softmax_order`): virtual thread
// t < sm_stride sums entries t, t + sm_stride, ... (sm_reg of them) from
// 0, in order; each 32 virtual threads sum by a halving tree (v_i + v_{i +
// 16}, then + 8, ...: a warp's shuffle-down reduction), and the sm_nth /
// 32 warp sums, zero-padded to 32, by the same tree. Masked entries and
// those past Sk add exact zeros, so only the row's keys are visited.
__global__ void __launch_bounds__(256) gqa_exp(const Args a) {
  const int bg = blockIdx.x;
  const int r = blockIdx.y * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (r >= a.R) return;
  int lo, hi;
  bool empty;
  row_range(a, bg / a.Hkv, r, lo, hi, empty);
  const long long row = static_cast<long long>(bg) * a.R + r;
  float mx = -INFINITY;
  for (int u = lo / kSplit; u <= (hi - 1) / kSplit; ++u)
    mx = fmaxf(mx, a.pmax[row * a.T + u]);
  float* s = a.scores + row * a.Sk;
  float total = 0.f;
  for (int w = 0; w < a.sm_nth / 32; ++w) {
    const int t = w * 32 + lane;
    float ts = 0.f;
    if (t < a.sm_stride) {
      for (int q = 0; q < a.sm_reg; ++q) {
        const int key = t + q * a.sm_stride;
        if (key >= lo && key < hi) {
          const float e = expf(__fsub_rn(s[key], mx));
          s[key] = e;
          ts = __fadd_rn(ts, e);
        }
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      ts = __fadd_rn(ts, __shfl_down_sync(0xffffffffu, ts, o));
    ts = __shfl_sync(0xffffffffu, ts, 0);
    if (lane == w) total = ts;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    total = __fadd_rn(total, __shfl_down_sync(0xffffffffu, total, o));
  if (lane == 0) a.psum[row] = total;
}

// p of row r at `key`: e / sum in f32, rounded to the input type; 0 off
// the row's range.
template <typename In>
__device__ __forceinline__ float prob(const Args& a, int bg, int r, int key,
                                      int lo, int hi, float sum) {
  if (r >= a.R || key < lo || key >= hi) return 0.f;
  return round_in<In>(__fdiv_rn(
      a.scores[(static_cast<long long>(bg) * a.R + r) * a.Sk + key], sum));
}

// Pass 3 on DMMA: 256 threads, 8 warps (2 x 16 rows, 4 x DP / 4 dims)
// over kValueRows rows; per split the chain over its keys, kValueKeys of
// V and p staged at a time. whole: every split the rows attend, summed
// in split order here and rounded into `out`; else split blockIdx.x into
// opart.
template <typename In, int DP>
__global__ void __launch_bounds__(256)
gqa_values_mma(const Args a, int whole) {
  constexpr int LDP = kValueKeys + 4, LDV = DP + 8, NT = DP / 32;
  extern __shared__ float smem[];
  float* ps = smem;                          // [kValueRows][LDP]
  float* vs = smem + kValueRows * LDP;       // [kValueKeys][LDV]
  __shared__ int s_lo[kValueRows], s_hi[kValueRows];
  __shared__ float s_sum[kValueRows];
  __shared__ int s_union[2];
  const int bg = blockIdx.y, r0 = blockIdx.z * kValueRows;
  const int b = bg / a.Hkv, g = bg % a.Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  if (tid == 0) {
    s_union[0] = a.Sk;
    s_union[1] = 0;
  }
  __syncthreads();
  if (tid < kValueRows) {
    const int r = r0 + tid;
    int lo = 0, hi = 0;
    bool empty = false;
    float sum = 0.f;
    if (r < a.R) {
      row_range(a, b, r, lo, hi, empty);
      sum = a.psum[static_cast<long long>(bg) * a.R + r];
      atomicMin(&s_union[0], lo);
      atomicMax(&s_union[1], hi);
    }
    s_lo[tid] = lo;
    s_hi[tid] = hi;
    s_sum[tid] = sum;
  }
  __syncthreads();
  const int ulo = s_union[0], uhi = s_union[1];
  int t0 = blockIdx.x, t1 = t0 + 1;
  if (whole) {
    t0 = ulo / kSplit;
    t1 = ulo < uhi ? (uhi - 1) / kSplit + 1 : t0;
  } else if (t0 * kSplit >= uhi || (t0 + 1) * kSplit <= ulo) {
    return;
  }
  double total[NT][4];
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) total[nt][i] = 0.0;
  for (int t = t0; t < t1; ++t) {
    double acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[nt][i] = 0.0;
    const int k_begin = t * kSplit, k_end = min(a.Sk, k_begin + kSplit);
    for (int kt = k_begin; kt < k_end; kt += kValueKeys) {
      if (kt >= uhi || kt + kValueKeys <= ulo) continue;
      __syncthreads();
      stage<In, kValueKeys, DP, LDV, 256>(vs, a.v, a, [&](int kl) {
        const int key = kt + kl;
        return key >= ulo && key < uhi
                   ? b * a.v_sb + key * a.v_ss + g * a.v_sh : -1LL;
      });
#pragma unroll
      for (int u = 0; u < kValueRows * kValueKeys / 256; ++u) {
        const int i = tid + u * 256, rl = i / kValueKeys, kl = i % kValueKeys;
        ps[rl * LDP + kl] = prob<In>(a, bg, r0 + rl, kt + kl, s_lo[rl],
                                     s_hi[rl], s_sum[rl]);
      }
      __syncthreads();
#pragma unroll 4
      for (int k0 = 0; k0 < kValueKeys; k0 += 4) {
        const float* pr = ps + (wm * 16 + (lane >> 2)) * LDP + k0 + (lane & 3);
        const double a0 = pr[0], a1 = pr[8 * LDP];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          cim::dmma(acc[nt], a0, a1,
                    vs[(k0 + (lane & 3)) * LDV + wn * (DP / 4) + nt * 8 +
                       (lane >> 2)]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = r0 + wm * 16 + (lane >> 2) + (i >> 1) * 8;
        const int col = wn * (DP / 4) + nt * 8 + 2 * (lane & 3) + (i & 1);
        if (whole)
          total[nt][i] = __dadd_rn(total[nt][i], acc[nt][i]);
        else if (r < a.R)
          a.opart[((static_cast<long long>(bg) * a.T + t) * a.R + r) * DP +
                  col] = acc[nt][i];
      }
  }
  if (!whole) return;
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + wm * 16 + (lane >> 2) + (i >> 1) * 8;
      const int col = wn * (DP / 4) + nt * 8 + 2 * (lane & 3) + (i & 1);
      if (r < a.R && col < a.D)
        store_out<In>(a.out, out_index(a, b, g, r) + col, total[nt][i]);
    }
}

// Pass 3 on the CUDA cores: DP threads, one dim each, NR rows; split
// blockIdx.x into opart, kFmaKeys of V and p staged at a time.
template <typename In, int DP, int NR>
__global__ void __launch_bounds__(DP)
gqa_values_fma(const Args a) {
  __shared__ float ps[NR][kFmaKeys];
  __shared__ float vs[kFmaKeys][DP];
  __shared__ int s_lo[NR], s_hi[NR];
  __shared__ float s_sum[NR];
  __shared__ int s_union[2];
  const int t = blockIdx.x, bg = blockIdx.y, r0 = blockIdx.z * NR;
  const int b = bg / a.Hkv, g = bg % a.Hkv;
  const int tid = threadIdx.x;
  if (tid == 0) {
    s_union[0] = a.Sk;
    s_union[1] = 0;
  }
  __syncthreads();
  if (tid < NR) {
    const int r = r0 + tid;
    int lo = 0, hi = 0;
    bool empty = false;
    float sum = 0.f;
    if (r < a.R) {
      row_range(a, b, r, lo, hi, empty);
      sum = a.psum[static_cast<long long>(bg) * a.R + r];
      atomicMin(&s_union[0], lo);
      atomicMax(&s_union[1], hi);
    }
    s_lo[tid] = lo;
    s_hi[tid] = hi;
    s_sum[tid] = sum;
  }
  __syncthreads();
  const int ulo = s_union[0], uhi = s_union[1];
  const int k_begin = t * kSplit, k_end = min(a.Sk, k_begin + kSplit);
  if (k_begin >= uhi || k_end <= ulo) return;
  double acc[NR];
#pragma unroll
  for (int r = 0; r < NR; ++r) acc[r] = 0.0;
  for (int kt = k_begin; kt < k_end; kt += kFmaKeys) {
    if (kt >= uhi || kt + kFmaKeys <= ulo) continue;
    __syncthreads();
#pragma unroll 8
    for (int kl = 0; kl < kFmaKeys; ++kl) {
      const int key = kt + kl;
      put<In>(&vs[kl][tid], a.v, b * a.v_sb + key * a.v_ss + g * a.v_sh + tid,
              key >= ulo && key < uhi && tid < a.D);
    }
    for (int i = tid; i < NR * kFmaKeys; i += DP) {
      const int rl = i / kFmaKeys, kl = i % kFmaKeys;
      ps[rl][kl] = prob<In>(a, bg, r0 + rl, kt + kl, s_lo[rl], s_hi[rl],
                            s_sum[rl]);
    }
    cp_wait();
    __syncthreads();
#pragma unroll
    for (int j = 0; j < kFmaKeys; j += 4) {
      const double v0 = vs[j][tid], v1 = vs[j + 1][tid], v2 = vs[j + 2][tid],
                   v3 = vs[j + 3][tid];
#pragma unroll
      for (int r = 0; r < NR; ++r)
        acc[r] = fma4(acc[r], ps[r][j], ps[r][j + 1], ps[r][j + 2],
                      ps[r][j + 3], v0, v1, v2, v3);
    }
  }
#pragma unroll
  for (int r = 0; r < NR; ++r)
    if (r0 + r < a.R)
      a.opart[((static_cast<long long>(bg) * a.T + t) * a.R + r0 + r) * DP +
              tid] = acc[r];
}

// Pass 4 (split mode): each output's per-split chains over the splits its
// row attends, in split order, rounded once.
template <typename In>
__global__ void __launch_bounds__(256) gqa_combine(const Args a, int dp) {
  const int bg = blockIdx.y;
  const long long i = static_cast<long long>(blockIdx.x) * 256 + threadIdx.x;
  const int r = static_cast<int>(i / a.D), d = static_cast<int>(i % a.D);
  if (r >= a.R) return;
  const int b = bg / a.Hkv, g = bg % a.Hkv;
  int lo, hi;
  bool empty;
  row_range(a, b, r, lo, hi, empty);
  double total = 0.0;
  for (int t = lo / kSplit; t <= (hi - 1) / kSplit; ++t)
    total = __dadd_rn(
        total, a.opart[((static_cast<long long>(bg) * a.T + t) * a.R + r) * dp +
                       d]);
  store_out<In>(a.out, out_index(a, b, g, r) + d, total);
}

// One m16n8k4 DMMA on (A, B, C) into D, and `fma4` on every output into
// E, for the card test that holds the CUDA-core route to the DMMA's bits.
__global__ void gqa_dmma_probe_kernel(const double* A, const double* Bm,
                                      const double* C, double* Dm,
                                      double* E) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    const int r = lane >> 2, c = 2 * (lane & 3);
    double d[4] = {C[r * 8 + c], C[r * 8 + c + 1], C[(r + 8) * 8 + c],
                   C[(r + 8) * 8 + c + 1]};
    cim::dmma(d, A[r * 4 + (lane & 3)], A[(r + 8) * 4 + (lane & 3)],
              Bm[(lane & 3) * 8 + r]);
    Dm[r * 8 + c] = d[0];
    Dm[r * 8 + c + 1] = d[1];
    Dm[(r + 8) * 8 + c] = d[2];
    Dm[(r + 8) * 8 + c + 1] = d[3];
  }
  if (tid < 128) {
    const int i = tid / 8, j = tid % 8;
    E[i * 8 + j] = fma4(C[i * 8 + j], A[i * 4], A[i * 4 + 1], A[i * 4 + 2],
                        A[i * 4 + 3], Bm[j], Bm[8 + j], Bm[16 + j], Bm[24 + j]);
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (allowed == 0) allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

int cdiv(long long a, long long b) { return static_cast<int>((a + b - 1) / b); }

template <typename In, int DP>
int scores_mma_smem() { return 2 * kScoreRows * (DP + 4) * 4; }

template <typename In, int DP>
int values_mma_smem() {
  return (kValueRows * (kValueKeys + 4) + kValueKeys * (DP + 8)) * 4;
}

// The four passes on `stream`; the first CUDA error, else 0.
template <typename In, int DP>
int launch_all(const Args& a, int mma, int whole, cudaStream_t stream) {
  const int bgs = a.B * a.Hkv;
  const bool one_row = a.R == 1;
  cudaError_t err;
  if (mma) {
    static int allowed = 0;
    const int smem = scores_mma_smem<In, DP>();
    if ((err = allow_smem(gqa_scores_mma<In, DP>, smem, allowed))) return err;
    gqa_scores_mma<In, DP>
        <<<dim3(a.T, bgs, cdiv(a.R, kScoreRows)), 128, smem, stream>>>(a);
  } else if (one_row) {
    gqa_scores_fma<In, DP, 1><<<dim3(a.T, bgs, a.R), kSplit, 0, stream>>>(a);
  } else {
    gqa_scores_fma<In, DP, kMmaRows>
        <<<dim3(a.T, bgs, cdiv(a.R, kMmaRows)), kSplit, 0, stream>>>(a);
  }
  if ((err = cudaGetLastError())) return err;
  gqa_exp<<<dim3(bgs, cdiv(a.R, 8)), 256, 0, stream>>>(a);
  if ((err = cudaGetLastError())) return err;
  if (mma) {
    static int allowed = 0;
    const int smem = values_mma_smem<In, DP>();
    if ((err = allow_smem(gqa_values_mma<In, DP>, smem, allowed))) return err;
    gqa_values_mma<In, DP><<<dim3(whole ? 1 : a.T, bgs, cdiv(a.R, kValueRows)),
                             256, smem, stream>>>(a, whole);
  } else if (one_row) {
    gqa_values_fma<In, DP, 1><<<dim3(a.T, bgs, a.R), DP, 0, stream>>>(a);
  } else {
    gqa_values_fma<In, DP, kMmaRows>
        <<<dim3(a.T, bgs, cdiv(a.R, kMmaRows)), DP, 0, stream>>>(a);
  }
  if ((err = cudaGetLastError())) return err;
  if (!whole) {
    gqa_combine<In><<<dim3(cdiv(static_cast<long long>(a.R) * a.D, 256), bgs),
                      256, 0, stream>>>(a, DP);
    if ((err = cudaGetLastError())) return err;
  }
  return 0;
}

template <typename In>
int launch_dp(const Args& a, int dp, int mma, int whole, cudaStream_t s) {
  switch (dp) {
    case 32: return launch_all<In, 32>(a, mma, whole, s);
    case 64: return launch_all<In, 64>(a, mma, whole, s);
    case 128: return launch_all<In, 128>(a, mma, whole, s);
    case 256: return launch_all<In, 256>(a, mma, whole, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// Attention of q (B, Sq, H, D) over k, v (B, Sk, Hkv, D) into out (B, Sq,
// H, D, contiguous) on `stream`; dtype 0 = float32, 1 = bfloat16. Strides
// in elements; the last dim of q, k and v dense. q_pos: int64, (B, Sq)
// with qpos_sb = Sq or (Sq,) with qpos_sb = 0; kv_len: an int64 (B,)
// tensor or nullptr (then kv_fill for every slot). dp: the padded head
// dim (32, 64, 128 or 256, >= D); mma: the products on DMMA (else the
// CUDA cores); whole: pass 3 sums the splits in the block (DMMA only);
// vec: f32 q, k and v whose rows start on the 16-byte grid (D % 4 == 0).
// sm_stride, sm_reg, sm_nth: the order of the softmax sum (pass 2).
// Scratch: scores (B Hkv R Sk f32), pmax (B Hkv R T f32), psum (B Hkv R
// f32), opart (B Hkv T R dp f64, unused when whole). Returns the first CUDA error (0 =
// launched).
int gqa_attention_launch(const void* q, const void* k, const void* v,
                         void* out, int dtype, int B, int Sq, int H, int Hkv,
                         int D, int Sk, long long q_sb, long long q_ss,
                         long long q_sh, long long k_sb, long long k_ss,
                         long long k_sh, long long v_sb, long long v_ss,
                         long long v_sh, const long long* q_pos,
                         long long qpos_sb, const long long* kv_len,
                         long long kv_fill, int causal, int window,
                         float scale, float softcap, float inv_cap,
                         float* scores, float* pmax, float* psum,
                         int sm_stride, int sm_reg, int sm_nth,
                         double* opart, int dp, int mma, int whole,
                         int vec, void* stream) {
  if (B < 1 || Sq < 1 || Hkv < 1 || H % Hkv || D < 1 || D > dp || Sk < 1 ||
      (whole && !mma) || sm_stride < 1 || sm_stride > sm_nth ||
      sm_nth % 32 || sm_nth > 1024 || sm_stride * sm_reg < Sk)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{q, k, v, out, B, Sq, H, Hkv, D, Sk, H / Hkv, (H / Hkv) * Sq,
         cdiv(Sk, kSplit), q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
         v_sh, q_pos, qpos_sb, kv_len, kv_fill, causal, window, scale,
         softcap, inv_cap, scores, pmax, psum, sm_stride, sm_reg, sm_nth,
         vec, opart};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dp<float>(a, dp, mma, whole, s);
  if (dtype == 1) return launch_dp<__nv_bfloat16>(a, dp, mma, whole, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// One DMMA and its CUDA-core emulation (`fma4`) on a 16 x 4 A, a 4 x 8 B
// and a 16 x 8 C (row-major f64 on the device) into D and E; on `stream`.
int gqa_dmma_probe(const double* A, const double* Bm, const double* C,
                   double* Dm, double* E, void* stream) {
  gqa_dmma_probe_kernel<<<1, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      A, Bm, C, Dm, E);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"

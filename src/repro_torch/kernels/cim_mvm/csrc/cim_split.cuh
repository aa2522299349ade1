// The split route of the packed and scheduled NeuRRAM CIM kernels for
// Hopper (sm_90a): decode shapes, M up to the measured edge (kernel.py
// `split_route`). Included by cim_mvm_packed.cu and cim_mvm_scheduled.cu;
// each exports it as its `*_split_launch`. Larger batches take the walk
// (cim_walk.cuh).
//
// At decode a walk that gives each output column block's tiles to one
// block in slot order leaves most of the card idle (the first walk read
// gd at about 6% of the bytes bound at M = 4). The split route separates
// what needs an order from what does not:
//
//   * The tile dot needs none. x holds integers (|x| <= 127) and gd is a
//     multiple of 2^-23 below 2^6 (the verifier's `exact-dot`), so the FP64
//     sum over any split of k is exact, and so is its one rounding to f32.
//   * Only the fold needs order: with fold_norm denorms the terms
//     counts * weight are not integers, and the reference's left fold, in
//     slot order inside each run and in run order across a column block's
//     runs, fixes the bits.
//
// So two kernels, launched back to back on one stream:
//
//   cim_tile_terms<BM>  one block per LIVE slot t (idle slots, a merged
//       plan's pass padding, are neither computed nor read). The tile,
//       one contiguous bk * bn * 4-byte block of gd_tiles, streams through
//       a ring of kSplitStages chunks of kSplitChunkRows rows in shared
//       memory, each chunk one 1-D bulk copy (cp.async.bulk, the TMA's
//       tensor-map-free form) issued by one thread and completed on an
//       mbarrier. The bulk copy moves 16-byte-aligned multiples of 16
//       bytes, and a tile of bk * bn * 4 bytes (9,240 for the interleaved
//       RBM's 70 x 33 tiles) may start anywhere on the 4-byte grid: each
//       chunk copies its 16-byte-aligned cover into a stage 16 bytes
//       longer than a chunk, and the threads read it at the tile's offset
//       mod 16, the same for every chunk since a chunk is 64 * bn bytes.
//       The cover never leaves the 16-byte segments the tile touches, so
//       no read crosses into another page. The block's x rows are staged
//       once as doubles. One
//       thread per tile column sums its FP64 dot from shared memory, then
//       forms q = (f32(acc) * v_read) * inv_norm and the term through
//       cim_epilogue.cuh `tile_term` (the stochastic neuron hashed at
//       (row % bm_ref, col) with salts (seed, row / bm_ref, t), as the
//       walk), written to terms[t, m, c] (a (T, M, bn) scratch the wrapper
//       allocates). The ring (3 stages of 16 rows, 48 KB at bn = 256) is
//       sized for four blocks per SM at BM = 4 and three at BM = 16, up
//       to 144-192 KB of copies in flight per SM at full width.
//   cim_fold_runs  one thread per (row, output column): its column block's
//       live runs in run order, each run's slots in slot order,
//         part = 0.f; part += term ...; total += part   (__fadd_rn)
//       from 0.f, never from the first term (0.f + -0.f is +0.f in the
//       plain version too), one write per output, no atomics. The packed
//       kernel passes col_start as run_start and no column-run tables:
//       column block j's only run is run j.
//
// Shared memory of a term block: kSplitBarrierBytes + kSplitStages *
// (kSplitChunkRows * bn * 4 + 16) + bk * BM * 8 bytes (dynamic; 53,424 at
// BM = 4 and 65,712 at BM = 16 for a 128 x 256 tile), `split_shared_bytes`.
#pragma once

#include "bulk_copy.cuh"
#include "cim_epilogue.cuh"

namespace cim {

constexpr int kSplitThreads = 256;      // most tile columns (one thread each)
constexpr int kSplitChunkRows = 16;     // tile rows per bulk copy
constexpr int kSplitStages = 3;         // chunks in flight per block
constexpr int kStageBatch = 16;         // x loads in flight per thread
constexpr int kSplitBarrierBytes = 128; // the stages' mbarriers, padded
constexpr int kFoldThreads = 256;
constexpr int kFoldUnroll = 16;         // terms loaded before they are added

// Bytes of one ring stage: a chunk and the slack of its aligned cover.
inline __host__ __device__ int split_stage_bytes(int bn) {
  return kSplitChunkRows * bn * 4 + 16;
}

// Dynamic shared memory of one term block at BM rows.
inline int split_shared_bytes(int bm, int bk, int bn) {
  return kSplitBarrierBytes + kSplitStages * split_stage_bytes(bn) +
         bk * bm * 8;
}

struct SplitArgs {
  const float* x;
  int M, K;
  const float* gd;          // (T, bk, bn)
  const float* inv_norm;    // (T, 1, bn)
  const float* denorm;      // (T, 1, bn)
  const float* v_decr;      // (T,)
  const int* row_block;     // (T,) input block per slot
  const int* live;          // live slots in slot order; nullptr: all slots
  int bk, bn;
  float* terms;             // (T, M, bn) scratch
  const int* run_start;     // (n_runs + 1,) CSR slots of each run
  const int* col_run_start; // (n_cb + 1,) CSR live runs per column block;
  const int* col_runs;      //   nullptr: column block j's only run is j
  int n_col_blocks;
  float* out;               // (M, n_col_blocks * bn)
};

// acc[r] += x[r] * gv for the BM staged rows xr (16-byte aligned doubles).
template <int BM>
__device__ __forceinline__ void row_fma(double (&acc)[BM],
                                        const double* xr, double gv) {
#pragma unroll
  for (int r = 0; r < BM; r += 2) {
    const double2 xv = *reinterpret_cast<const double2*>(xr + r);
    acc[r] = fma(xv.x, gv, acc[r]);
    acc[r + 1] = fma(xv.y, gv, acc[r + 1]);
  }
}

template <int BM>
__global__ void __launch_bounds__(kSplitThreads)
cim_tile_terms(SplitArgs a, Epilogue e) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kSplitBarrierBytes;
  const int bk = a.bk, bn = a.bn;
  const int stage_bytes = split_stage_bytes(bn);
  double* xs = reinterpret_cast<double*>(ring + kSplitStages * stage_bytes);
  const int t = a.live ? a.live[blockIdx.x] : (int)blockIdx.x;
  const float* tile = a.gd + (size_t)t * bk * bn;
  // the tile's offset mod 16, that of every chunk (a chunk is 64 * bn B)
  const int shift = (int)(reinterpret_cast<uintptr_t>(tile) & 15);
  const int n_chunks = (bk + kSplitChunkRows - 1) / kSplitChunkRows;

  auto issue = [&](int i) {          // chunk i into stage i % kSplitStages
    const int s = i % kSplitStages;
    const int rows = min(kSplitChunkRows, bk - i * kSplitChunkRows);
    const uint32_t bytes = (uint32_t)((shift + rows * bn * 4 + 15) & ~15);
    const uint32_t bar = smem_u32(&bars[s]);
    mbar_expect_tx(bar, bytes);
    bulk_load(smem_u32(ring + s * stage_bytes),
              reinterpret_cast<const unsigned char*>(
                  tile + (size_t)i * kSplitChunkRows * bn) - shift,
              bytes, bar);
  };

  if (threadIdx.x == 0) {
    for (int s = 0; s < kSplitStages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();                   // barriers initialised
  if (threadIdx.x == 0)
    for (int i = 0; i < min(kSplitStages, n_chunks); ++i) issue(i);

  // the block's x rows as doubles, xs[k][r], while the first chunks land;
  // kStageBatch loads in flight per thread (a 64-thread block stages
  // 2,048 values at BM = 16)
  const int kbase = a.row_block[t] * bk, n_x = BM * bk;
  for (int i0 = threadIdx.x; i0 < n_x; i0 += kStageBatch * blockDim.x) {
    float v[kStageBatch];
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      const int r = i / bk, col = kbase + i % bk;
      v[u] = (i < n_x && r < a.M && col < a.K) ? a.x[(size_t)r * a.K + col]
                                               : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kStageBatch; ++u) {
      const int i = i0 + u * blockDim.x;
      if (i < n_x) xs[(i % bk) * BM + i / bk] = (double)v[u];
    }
  }
  const int c = threadIdx.x;
  const bool live = c < bn;
  float inv = 0.f, w = 0.f;
  if (live) {
    inv = a.inv_norm[(size_t)t * bn + c];
    w = a.denorm[(size_t)t * bn + c];
  }
  const float vd = a.v_decr[t];
  __syncthreads();                   // x staged

  double acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.0;
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kSplitStages;
    mbar_wait(smem_u32(&bars[s]), (uint32_t)((i / kSplitStages) & 1));
    const float* g = reinterpret_cast<const float*>(
        ring + s * stage_bytes + shift) + c;
    const double* xk = xs + (size_t)i * kSplitChunkRows * BM;
    const int rows = min(kSplitChunkRows, bk - i * kSplitChunkRows);
    if (live) {
      if (rows == kSplitChunkRows) {
#pragma unroll
        for (int k = 0; k < kSplitChunkRows; ++k)
          row_fma<BM>(acc, xk + k * BM, (double)g[k * bn]);
      } else {
        for (int k = 0; k < rows; ++k)
          row_fma<BM>(acc, xk + k * BM, (double)g[k * bn]);
      }
    }
    __syncthreads();                 // stage s fully read: refill it
    if (threadIdx.x == 0 && i + kSplitStages < n_chunks) issue(i + kSplitStages);
  }
  if (!live) return;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    if (r < a.M) {
      const float q = __fmul_rn(__fmul_rn(__double2float_rn(acc[r]), e.v_read), inv);
      a.terms[((size_t)t * a.M + r) * bn + c] = tile_term(q, vd, inv, w, r, c, t, e);
    }
  }
}

__global__ void __launch_bounds__(kFoldThreads)
cim_fold_runs(SplitArgs a) {
  const int bn = a.bn, n_cb = a.n_col_blocks;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= (long long)a.M * n_cb * bn) return;
  const int c = (int)(idx % bn);
  const long long rest = idx / bn;
  const int cb = (int)(rest % n_cb), m = (int)(rest / n_cb);
  const int k_lo = a.col_run_start ? a.col_run_start[cb] : cb;
  const int k_hi = a.col_run_start ? a.col_run_start[cb + 1] : cb + 1;
  const size_t stride = (size_t)a.M * bn;          // terms per slot
  const float* base = a.terms + (size_t)m * bn + c;
  float total = 0.f;
  for (int k = k_lo; k < k_hi; ++k) {
    const int run = a.col_runs ? a.col_runs[k] : k;
    const int t_end = a.run_start[run + 1];
    float part = 0.f;
    // two batches of kFoldUnroll loads in flight: the next batch is
    // issued before the current one is added
    float v[kFoldUnroll], nxt[kFoldUnroll];
    int t = a.run_start[run];
#pragma unroll
    for (int u = 0; u < kFoldUnroll; ++u)
      v[u] = t + u < t_end ? base[(size_t)(t + u) * stride] : 0.f;
    for (; t < t_end; t += kFoldUnroll) {
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) {
        const int tn = t + kFoldUnroll + u;
        nxt[u] = tn < t_end ? base[(size_t)tn * stride] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u)
        if (t + u < t_end) part = __fadd_rn(part, v[u]);
#pragma unroll
      for (int u = 0; u < kFoldUnroll; ++u) v[u] = nxt[u];
    }
    total = __fadd_rn(total, part);
  }
  a.out[idx] = total;
}

// The dynamic shared memory cim_tile_terms<4> and <16> may request so far
// in this library. `static`: internal to the library that includes this
// header (a static local of the template below would be one symbol for
// every loaded library, and the second library would skip its own
// cudaFuncSetAttribute).
static int split_smem_allowed[2] = {48 * 1024, 48 * 1024};

// Both passes on `stream`: n_live term blocks, then the fold. Returns the
// first CUDA error (a refused attribute, a misaligned tile, a launch).
template <int BM>
cudaError_t split_launch(const SplitArgs& a, int n_live, const Epilogue& e,
                         cudaStream_t stream) {
  if (a.bn < 1 || a.bn > kSplitThreads || a.bk < 1)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(a.gd) & 3) ||
      (kSplitChunkRows * a.bn * 4) % 16)
    return cudaErrorMisalignedAddress;
  const int smem = split_shared_bytes(BM, a.bk, a.bn);
  int& allowed = split_smem_allowed[BM == 16];
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        cim_tile_terms<BM>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  if (n_live > 0) {
    const int threads = (a.bn + 31) / 32 * 32;
    cim_tile_terms<BM><<<n_live, threads, smem, stream>>>(a, e);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const long long n_out = (long long)a.M * a.n_col_blocks * a.bn;
  if (n_out > 0) {
    cim_fold_runs<<<(unsigned)((n_out + kFoldThreads - 1) / kFoldThreads),
                    kFoldThreads, 0, stream>>>(a);
  }
  return cudaGetLastError();
}

// The C entry points' split launch at `bm` rows (4 or 16).
inline int split_launch_bm(const SplitArgs& a, int n_live, const Epilogue& e,
                           int bm, cudaStream_t stream) {
  switch (bm) {
    case 4:  return (int)split_launch<4>(a, n_live, e, stream);
    case 16: return (int)split_launch<16>(a, n_live, e, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace cim

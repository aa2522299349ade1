// The walk of the packed, scheduled and transposed NeuRRAM CIM kernels
// for Hopper (sm_90a): the packed and scheduled kernels' batches above
// the split route's edge (kernel.py `split_route`), prefill, and every
// batch of the transposed kernel. Included by cim_mvm_packed.cu,
// cim_mvm_scheduled.cu and cim_mvm_transposed.cu; each exports it as its
// `*_launch`.
//
// What it computes (kernel.py `cim_runs_plain`): for each output column
// block j, its live runs in run order and each run's slots t in slot
// order,
//   acc    = x[:, row_block[t]] @ gd_tiles[t]               exact, FP64
//   q      = f32(acc) * v_read * inv_norm[t]                (f32)
//   term   = the ADC epilogue or the stochastic neuron, times its weight
//            (cim_epilogue.cuh `tile_term`, hashed at (row % bm_ref,
//            in-tile column) with salts (seed, row / bm_ref, t))
//   part   = ((0 + term_t0) + term_t1) + ...     per run, from 0.f
//   out    = ((0 + part_r0) + part_r1) + ...     over j's runs, from 0.f
// The packed kernel is this walk with one run per column block (run_start
// = col_start, no column-run tables): (0 + part) == part in f32, so its
// bits are those of a single left fold. The transposed kernel (TRANS) is
// the scheduled walk over the BL->SL view of the shared forward stack:
// slot t reads stored tile tile_slot[t] on its column axis (its stored
// rows are the outputs, its stored columns the contraction), and the
// stochastic neuron's tile salt is that stack position. One write per
// output, no atomics, no reduction across blocks.
//
// What bounds it: each gd element feeds M multiply-adds. At prefill (M =
// 256) that is the card's FP64 rate (no TF32: the counts round at .5
// boundaries); at small M the bytes of gd_tiles, read once.
//
// What the design does about it:
//   * the tile dot runs on the FP64 tensor cores (cim_dmma.cuh `dmma`,
//     mma.sync m16n8k4 f64). Exact in any order (cim_dmma.cuh), so k is
//     permuted inside each 16-row block of a tile: at k-step s, lane slot
//     q takes row 2q + (s & 1) + 8 (s >> 1). A lane reads its x values as
//     two 2-byte loads per row fragment, and the four slots of one k-step
//     read gd rows two apart, which a gd stage pitch of 4 mod 8 words puts
//     in four different bank octets (no conflicts); x rows at a pitch of
//     16 mod 32 bytes are conflict-free too. Transposed, a stage holds
//     the strip's stored rows (the outputs) at a pitch of 4 mod 8 words,
//     each the chunk's kc stored columns: the eight lanes of a k-slot read
//     eight rows, in eight different bank quartets, so slot q takes column
//     4 s + q, contiguous (no conflicts), and a lane reads its x values as
//     four 1-byte loads per row fragment (no permutation keeps both the
//     gd reads conflict-free and the x reads 2-byte wide).
//   * a block of 4 warps (2 x 2) owns an ITEM: bm rows of x times bn_blk
//     columns (a strip) of one output column block, 64 x 64, 32 x 64 or
//     32 x 32 (kernel.py `walk_geometry` takes the largest that gives
//     every SM an item, and none taller than the batch). Each lane keeps
//     its accumulator elements' FP64 sums (reset per tile) and their f32
//     part and total (across the whole walk) in registers.
//   * x reaches the walk as int8 (the wrapper casts it; |x| <= 127, so
//     exactly): a quarter of the bytes every item of a row block
//     re-reads, and a 64-row block's stage of 128 tile rows takes 44 KB,
//     so two blocks with two stages each fit an SM.
//   * gd and x stream through a ring of `stages` shared-memory stages,
//     each one chunk of kc <= 128 tile rows (the tile's gd rows of the
//     strip and the block's x rows of the same input columns), refilled
//     as soon as the block has read it, with one mbarrier per stage. An
//     operand whose rows sit on the 16-byte grid comes in ONE 2-D tensor
//     copy per stage (the TMA, cp.async.bulk.tensor, issued by thread 0;
//     zeros past the tensor's edges); gd at bn % 4 != 0 (bn = 47 on the
//     IR-drop chip) where one strip covers bn, in one 1-D bulk copy of the
//     chunk's contiguous rows; otherwise (a 35-row layer's x) every thread
//     copies its share of the rows' 16-byte covers by cp.async, and the
//     reader adds each row's offset mod 16. Transposed, a chunk spans all
//     of a tile's stored columns where they are off the 16-byte grid (the
//     RBM's 121 and 33, the IR-drop chip's 47), so the strip's stored rows
//     are contiguous: one bulk copy of their cover, read at pitch bk. (One 1-D bulk copy per row
//     left the walk bound by the copies' issue, and per-row cp.async by
//     the copies' latency, so the TMA takes every operand it can.)
//   * the epilogue, per output an IEEE division and the activation, has
//     one code path per activation and takes its operands (v_decr,
//     inv_norm, denorm) from loads issued when the tile's dot starts. The
//     division is a multiply by vd's reciprocal, checked: only a batch in
//     which some sum lands within 2^-20 of an integer is divided
//     (`walk_terms`), so a batch has no other branch and its outputs'
//     chains overlap.
//   * a persistent grid (blocks per SM from the runtime's occupancy, times
//     the SMs) walks the items; consecutive items are the row blocks of
//     one strip, so the blocks that read the same gd run together and
//     meet in L2.
// Shared memory (dynamic): kWalkBarrierBytes + stages * (bm * x pitch +
// gd rows * gd pitch * 4) bytes (x pitch in bytes, gd pitch in words; gd
// rows: kc forward, bn_blk transposed), `walk_shared_bytes`,
// kernel.walk_shared_bytes.
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "bulk_copy.cuh"
#include "cim_dmma.cuh"
#include "cim_epilogue.cuh"

namespace cim {

constexpr int kWalkWarps = 4;               // 2 x 2 warps per block
constexpr int kWalkThreads = 32 * kWalkWarps;
constexpr int kWalkBarrierBytes = 128;      // the stages' mbarriers, padded
constexpr int kWalkMaxStages = 4;
constexpr int kWalkLayouts = 3;
// rows and columns of an item per layout (4 warps of 16 RP rows x 8 GF
// columns each, 2 x 2)
constexpr int kWalkItem[kWalkLayouts][2] = {{64, 64}, {32, 64}, {32, 32}};

// Mirrors kernel.WalkGeometry (ctypes) field for field.
struct WalkGeometry {
  int layout;           // index into kWalkItem
  int bm, bn_blk;       // rows and columns of an item
  int n_rbk, n_strips;  // row blocks of x; strips of a column block
  int kc;               // contraction per stage (a multiple of 16, <= 128;
                        //   transposed off the 16-byte grid: all of bk)
  int stages;           // ring stages
  int n_items;          // n_rbk * n_strips * n_col_blocks
  int trans;            // 1: the transposed walk
};

// Mirrors kernel.WalkArgs.
struct WalkArgs {
  const int8_t* x;            // (M, K) the integer inputs, |x| <= 127
  int M, K;
  const float* gd;            // (T, bk, bn)
  const float* inv_norm;      // (T, 1, bn)
  const float* denorm;        // (T, 1, bn)
  const float* v_decr;        // (T,)
  const int* row_block;       // (T,) input block per slot
  const int* tile_slot;       // (T,) stack position per slot (transposed)
  const int* run_start;       // (n_runs + 1,) CSR slots of each run
  const int* col_run_start;   // (n_cb + 1,) CSR live runs per column block;
  const int* col_runs;        //   nullptr: column block j's only run is j
  int n_tiles, n_col_blocks;  // stack tiles, output column blocks
  int bk, bn;                 // contraction and output width of a tile
                              //   (stored (bk, bn); transposed (bn, bk))
  float* out;                 // (M, n_col_blocks * bn)
};

// How a stage's operand is filled: one 2-D tensor copy by the TMA (its
// tensor map) where its rows sit on the 16-byte grid (x: K % 16 == 0; gd:
// bn % 4 == 0); for gd otherwise, where one strip covers bn, the chunk's
// rows are contiguous and one 1-D bulk copy moves their 16-byte cover
// (read at pitch bn); else every thread copies its share of the rows'
// covers by cp.async.
enum WalkCopy { kCopyRows = 0, kCopyTensor = 1, kCopyBulk = 2 };

struct WalkMaps {
  CUtensorMap x, gd;          // x as (M, K) int8; gd_tiles as (T * bk, bn)
                              //   ((T * bn, bk) transposed)
  int x_mode, gd_mode;        // WalkCopy
};

// Bytes per staged x row: the cover of kc int8 values, = 16 mod 32.
__host__ __device__ __forceinline__ int walk_x_pitch(int kc) {
  const int p = kc + 16;
  return p + (48 - p % 32) % 32;
}

// Words per staged gd row: the cover of bn_blk values, = 4 mod 8.
__host__ __device__ __forceinline__ int walk_g_pitch(int bn_blk) {
  const int p = bn_blk + 4;
  return p + (12 - p % 8) % 8;
}

// The gd stage's rows and their pitch in words: kc tile rows of the
// strip's columns (forward), or the strip's bn_blk stored rows of the
// chunk's columns (transposed).
__host__ __device__ __forceinline__ int walk_g_rows(const WalkGeometry& g) {
  return g.trans ? g.bn_blk : g.kc;
}

__host__ __device__ __forceinline__ int walk_g_stage_pitch(const WalkGeometry& g) {
  return walk_g_pitch(g.trans ? g.kc : g.bn_blk);
}

__host__ __device__ __forceinline__ int walk_stage_bytes(const WalkGeometry& g) {
  return g.bm * walk_x_pitch(g.kc) + walk_g_rows(g) * walk_g_stage_pitch(g) * 4;
}

__host__ __device__ __forceinline__ int walk_shared_bytes(const WalkGeometry& g) {
  return kWalkBarrierBytes + g.stages * walk_stage_bytes(g);
}

// Item -> (row block, strip, column block): the row blocks of one strip
// are consecutive.
__device__ __forceinline__ void walk_item(const WalkGeometry& g, int item,
                                          int& rbk, int& strip, int& cb) {
  rbk = item % g.n_rbk;
  const int rest = item / g.n_rbk;
  strip = rest % g.n_strips;
  cb = rest / g.n_strips;
}

// The producer's place in the walk: item, run rank k, slot t, chunk c.
struct WalkCursor {
  int item, k, k_end, t, t_end, c;
};

// From run rank u.k on: the first run with a slot.
template <bool RUNS>
__device__ __forceinline__ bool cursor_run(const WalkArgs& a, WalkCursor& u) {
  for (; u.k < u.k_end; ++u.k) {
    const int run = RUNS ? a.col_runs[u.k] : u.k;
    u.t = a.run_start[run];
    u.t_end = a.run_start[run + 1];
    if (u.t < u.t_end) {
      u.c = 0;
      return true;
    }
  }
  return false;
}

// From item u.item on (stride gridDim.x): the first item with a slot.
template <bool RUNS>
__device__ __forceinline__ bool cursor_item(const WalkArgs& a, const WalkGeometry& g,
                                            WalkCursor& u) {
  for (; u.item < g.n_items; u.item += gridDim.x) {
    int rbk, strip, cb;
    walk_item(g, u.item, rbk, strip, cb);
    u.k = RUNS ? a.col_run_start[cb] : cb;
    u.k_end = RUNS ? a.col_run_start[cb + 1] : cb + 1;
    if (cursor_run<RUNS>(a, u)) return true;
  }
  return false;
}

// The next unit after u, in the consumers' order; false past the last.
template <bool RUNS>
__device__ __forceinline__ bool cursor_next(const WalkArgs& a, const WalkGeometry& g,
                                            WalkCursor& u, int n_chunks) {
  if (++u.c < n_chunks) return true;
  u.c = 0;
  if (++u.t < u.t_end) return true;
  ++u.k;
  if (cursor_run<RUNS>(a, u)) return true;
  u.item += gridDim.x;
  return cursor_item<RUNS>(a, g, u);
}

// Bytes of the 16-byte aligned cover of `bytes` at src.
__device__ __forceinline__ uint32_t cover_bytes(uintptr_t src, int bytes) {
  return (uint32_t)(((src + (uintptr_t)bytes + 15) & ~(uintptr_t)15) - (src & ~(uintptr_t)15));
}

// Copies n rows (row r's `bytes` at src0 + r * stride) into shared memory
// at dst0 + r * pitch: each row's 16-byte aligned cover, 16 bytes a
// cp.async, kCopyLanes threads to a row.
constexpr int kCopyLanes = 16;
__device__ __forceinline__ void copy_rows(uint32_t dst0, int pitch, uintptr_t src0,
                                          size_t stride, int n, int bytes, int tid) {
  constexpr int kRowsAtOnce = kWalkThreads / kCopyLanes;
  for (int r = tid / kCopyLanes; r < n; r += kRowsAtOnce) {
    const uintptr_t src = src0 + (uintptr_t)r * stride;
    const uintptr_t base = src & ~(uintptr_t)15, end = src + (uintptr_t)bytes;
    const uint32_t dst = dst0 + (uint32_t)(r * pitch);
    for (int q = 16 * (tid % kCopyLanes); base + q < end; q += 16 * kCopyLanes)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                   :: "r"(dst + (uint32_t)q), "l"(base + q) : "memory");
  }
}

// One 2-D tensor copy (TMA) of the box at (c0, c1) of `map` into `dst`,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap& map, int c0,
                                         int c1, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3}], [%4];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(&map)), "r"(c0), "r"(c1), "r"(bar)
      : "memory");
}

// Fills `stage` with unit u: the block's x rows of the chunk's input
// columns (bm rows at x pitch), then the chunk's gd rows of the strip (kc
// rows at gd pitch, or bn for a bulk copy; transposed, the strip's stored
// rows of the chunk's columns at gd pitch, or bk). Thread 0 issues the
// tensor and bulk copies (a tensor copy moves its operand's whole box,
// zeros past the tensor's edge) with their bytes expected on `bar`; for
// an operand copied row by row every thread copies its share of the rows'
// covers and arrives on `bar` when they land (the barrier then counts the
// block's threads and thread 0's arrival).
template <bool TRANS>
__device__ __forceinline__ void walk_issue(const WalkArgs& a, const WalkGeometry& g,
                                           const WalkMaps& maps, const WalkCursor& u,
                                           unsigned char* stage, uint32_t bar, int tid) {
  int rbk, strip, cb;
  walk_item(g, u.item, rbk, strip, cb);
  const int m0 = rbk * g.bm, rows = min(g.bm, a.M - m0);
  const int k0 = u.c * g.kc, kg = min(g.kc, a.bk - k0);
  const int kcol = a.row_block[u.t] * a.bk + k0;
  const int kx = max(0, min(kg, a.K - kcol));
  const int c0 = strip * g.bn_blk, ncol = min(g.bn_blk, a.bn - c0);
  const int px = walk_x_pitch(g.kc), pg = walk_g_stage_pitch(g);
  const int gt = TRANS ? a.tile_slot[u.t] : u.t;          // stack position
  const uintptr_t gsrc = reinterpret_cast<uintptr_t>(
      a.gd + (size_t)gt * a.bk * a.bn +
      (TRANS ? (size_t)c0 * a.bk + k0 : (size_t)k0 * a.bn + c0));
  const uint32_t gdst = smem_u32(stage + g.bm * px);
  if (tid == 0) {
    // the stage's reads (generic proxy) before the copies' writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t bulk = maps.gd_mode == kCopyBulk
        ? cover_bytes(gsrc, (TRANS ? ncol * a.bk : kg * a.bn) * 4) : 0;
    mbar_expect_tx(bar, (maps.x_mode == kCopyTensor ? g.bm * px : 0) +
                            (maps.gd_mode == kCopyTensor ? walk_g_rows(g) * pg * 4 : 0) +
                            bulk);
    if (maps.x_mode == kCopyTensor) tma_load(smem_u32(stage), maps.x, kcol, m0, bar);
    if (maps.gd_mode == kCopyTensor) {
      if (TRANS) tma_load(gdst, maps.gd, k0, gt * a.bn + c0, bar);
      else tma_load(gdst, maps.gd, c0, u.t * a.bk + k0, bar);
    }
    if (bulk)
      bulk_load(gdst, reinterpret_cast<const void*>(gsrc & ~(uintptr_t)15), bulk, bar);
  }
  if (maps.x_mode == kCopyRows && kx > 0)
    copy_rows(smem_u32(stage), px,
              reinterpret_cast<uintptr_t>(a.x + (size_t)m0 * a.K + kcol),
              (size_t)a.K, rows, kx, tid);
  if (!TRANS && maps.gd_mode == kCopyRows)   // (transposed: never, walk_launch)
    copy_rows(gdst, pg * 4, gsrc, (size_t)a.bn * 4, kg, ncol * 4, tid);
  if (maps.x_mode == kCopyRows || maps.gd_mode == kCopyRows)
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
}

// A tile's epilogue operands for one lane: v_decr[t] and the inv_norm and
// denorm of the lane's columns (zero past bn), loaded when the tile's dot
// starts so that their latency hides behind it.
template <int GF>
struct WalkTerms {
  float vd, inv[GF][2], den[GF][2];

  __device__ __forceinline__ WalkTerms(const WalkArgs& a, int t, int col0) {
    vd = __ldg(a.v_decr + t);
#pragma unroll
    for (int j = 0; j < GF; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + 8 * j + h;
        const bool ok = col < a.bn;
        inv[j][h] = ok ? __ldg(a.inv_norm + (size_t)t * a.bn + col) : 0.f;
        den[j][h] = ok ? __ldg(a.denorm + (size_t)t * a.bn + col) : 0.f;
      }
  }
};

// Slot t's terms q = (f32(acc) * v_read) * inv, then counts * weight (or
// the stochastic bit), added to the lane's run partials, for activation
// ACT (the epilogue's other branches fold away), kWalkBatch elements at a
// time. The ADC's steps floor(|q| / vd + 0.5) are first taken as t =
// |q| * (1 / vd) + 0.5 (the quotient within 2^-22 of the IEEE one, so t
// within 2^-21 t of the reference's sum); only where some t of the batch
// lies within 2^-20 t of an integer, where the floors could differ, is
// the batch divided (cim_epilogue.cuh `adc_steps`). The batch has no
// branch but that one, so its elements' chains overlap. salt: the tile's
// hash salt (its stack position); row0, col0: the row and the column
// (inside the column block) of the lane's first element.
constexpr int kWalkBatch = 8;

template <int ACT, int RP, int GF, int NS>
__device__ __forceinline__ void walk_terms(const Epilogue& e0,
                                           const double (&acc)[NS][RP][GF][4],
                                           const WalkTerms<GF>& w, int salt, int row0, int col0,
                                           float (&part)[RP * GF * 4]) {
  constexpr int NA = RP * GF * 4;
  constexpr int B = NA < kWalkBatch ? NA : kWalkBatch;
  constexpr bool kSteps = ACT != kIdentity && ACT != kStochastic;
  Epilogue e = e0;
  e.act = ACT;
  const float rvd = __frcp_rn(w.vd);
#pragma unroll
  for (int i0 = 0; i0 < NA; i0 += B) {
    float q[B], steps[B];
    bool divide = false;
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = i0 + u, p = i / (GF * 4), j = (i / 4) % GF, h = i % 4;
      double v = acc[0][p][j][h];
#pragma unroll
      for (int s = 1; s < NS; ++s) v += acc[s][p][j][h];
      q[u] = __fmul_rn(__fmul_rn(__double2float_rn(v), e.v_read), w.inv[j][h & 1]);
      if (kSteps) {
        const float tq = __fadd_rn(__fmul_rn(fabsf(q[u]), rvd), 0.5f);
        divide |= !(fabsf(__fsub_rn(tq, rintf(tq))) > __fmul_rn(tq, 0x1p-20f));
        steps[u] = floorf(tq);
      }
    }
    if (kSteps && divide) {
#pragma unroll
      for (int u = 0; u < B; ++u) steps[u] = adc_steps(q[u], w.vd);
    }
#pragma unroll
    for (int u = 0; u < B; ++u) {
      const int i = i0 + u, p = i / (GF * 4), j = (i / 4) % GF, h = i % 4;
      const float term = kSteps
          ? __fmul_rn(adc_count(q[u], steps[u], e), w.den[j][h & 1])
          : tile_term(q[u], w.vd, w.inv[j][h & 1], w.den[j][h & 1],
                      row0 + 16 * p + 8 * (h >> 1), col0 + 8 * j + (h & 1), salt, e);
      part[i] = __fadd_rn(part[i], term);
    }
  }
}

// One walk block: 4 warps of 16 RP rows x 8 GF columns (2 x 2). RUNS:
// the column-run tables are read (scheduled and transposed plans);
// otherwise column block j's only run is run j (packed plans). TRANS: the
// transposed walk (slot t reads stored tile tile_slot[t] on its column
// axis).
template <int RP, int GF, bool RUNS, bool TRANS>
__global__ void __launch_bounds__(kWalkThreads, 1)
cim_walk(WalkArgs a, WalkGeometry g, Epilogue e, const __grid_constant__ WalkMaps maps) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  unsigned char* ring = smem + kWalkBarrierBytes;
  const int px = walk_x_pitch(g.kc), pg = walk_g_stage_pitch(g);
  // staged gd row pitch (a bulk copy lands the stored rows contiguous)
  const int gp = maps.gd_mode == kCopyBulk ? (TRANS ? a.bk : a.bn) : pg;
  const int sbytes = walk_stage_bytes(g);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kk = lane & 3, lrow = lane >> 2;
  const int wrow = (warp >> 1) * 16 * RP, wcol = (warp & 1) * 8 * GF;
  const int n_chunks = (a.bk + g.kc - 1) / g.kc;
  const int out_ld = a.n_col_blocks * a.bn;
  constexpr int NA = RP * GF * 4;           // accumulator elements per lane
  // independent accumulator sets over a 16-row block's k-steps: more
  // DMMA chains in flight where a warp has few
  constexpr int NS = RP * GF >= 8 ? 1 : 2;

  if (threadIdx.x == 0) {
    const bool rows = maps.x_mode == kCopyRows || maps.gd_mode == kCopyRows;
    const int arrivals = 1 + (rows ? kWalkThreads : 0);
    for (int s = 0; s < g.stages; ++s) mbar_init(smem_u32(&bars[s]), arrivals);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // every thread produces: the cursor runs `stages` units ahead of the
  // units the block consumes
  WalkCursor cur{};
  cur.item = blockIdx.x;
  bool more = cursor_item<RUNS>(a, g, cur);
  for (int s = 0; s < g.stages && more; ++s) {
    walk_issue<TRANS>(a, g, maps, cur, ring + s * sbytes, smem_u32(&bars[s]), threadIdx.x);
    more = cursor_next<RUNS>(a, g, cur, n_chunks);
  }

  int unit = 0;
  for (int item = blockIdx.x; item < g.n_items; item += gridDim.x) {
    int rbk, strip, cb;
    walk_item(g, item, rbk, strip, cb);
    const int m0 = rbk * g.bm, c0 = strip * g.bn_blk;
    float total[NA], part[NA];
#pragma unroll
    for (int i = 0; i < NA; ++i) total[i] = 0.f;
    const int k_lo = RUNS ? a.col_run_start[cb] : cb;
    const int k_hi = RUNS ? a.col_run_start[cb + 1] : cb + 1;
    for (int k = k_lo; k < k_hi; ++k) {
      const int run = RUNS ? a.col_runs[k] : k;
#pragma unroll
      for (int i = 0; i < NA; ++i) part[i] = 0.f;
      const int t_end = a.run_start[run + 1];
      for (int t = a.run_start[run]; t < t_end; ++t) {
        double acc[NS][RP][GF][4];
#pragma unroll
        for (int q = 0; q < NS; ++q)
#pragma unroll
          for (int p = 0; p < RP; ++p)
#pragma unroll
            for (int j = 0; j < GF; ++j)
#pragma unroll
              for (int h = 0; h < 4; ++h) acc[q][p][j][h] = 0.0;
        const int kbase = a.row_block[t] * a.bk;
        const int row0 = m0 + wrow + lrow, col0 = c0 + wcol + 2 * kk;
        const WalkTerms<GF> terms(a, t, col0);
        const int gt = TRANS ? a.tile_slot[t] : t;   // stack position, hash salt
        // this lane's gd rows 2 kk + (s & 1) + 8 (s >> 1) of every 16-row
        // block: their offsets mod 16 (in words) are those of the tile
        // (transposed: the strip's first stored row)
        const uintptr_t tile = reinterpret_cast<uintptr_t>(
            a.gd + (size_t)gt * a.bk * a.bn + (TRANS ? (size_t)c0 * a.bk : c0));
        // (a tensor copy lands every row at its start, a bulk copy the
        // chunk at the tile's offset)
        int gofs[4];
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const int k = !TRANS && maps.gd_mode == kCopyRows
              ? 2 * kk + (s & 1) + 8 * (s >> 1) : 0;
          gofs[s] = maps.gd_mode == kCopyTensor
              ? 0 : (int)(((tile + (uintptr_t)k * a.bn * 4) & 15) >> 2);
        }

        for (int c = 0; c < n_chunks; ++c, ++unit) {
          const int st = unit % g.stages;
          mbar_wait(smem_u32(&bars[st]), (uint32_t)((unit / g.stages) & 1));
          const unsigned char* xs = ring + st * sbytes;
          const float* gs = reinterpret_cast<const float*>(xs + g.bm * px);
          const int k0 = c * g.kc, kg = min(g.kc, a.bk - k0);
          const int kx = max(0, min(kg, a.K - (kbase + k0)));
          // this lane's x rows in the stage (a row past M reads whatever
          // the stage holds: its outputs are never stored)
          const int8_t* xr[2 * RP];
          bool vec = true;
#pragma unroll
          for (int f = 0; f < 2 * RP; ++f) {
            const int r = wrow + 8 * f + lrow;
            const int row = m0 + r;
            const int off = row < a.M && maps.x_mode == kCopyRows
                ? (int)((reinterpret_cast<uintptr_t>(a.x) +
                         (size_t)row * a.K + kbase + k0) & 15) : 0;
            xr[f] = reinterpret_cast<const int8_t*>(xs + r * px + off);
            vec = vec && (off & 1) == 0;
          }
          vec = __all_sync(0xffffffffu, vec);
          const int n_blocks = (kg + 15) / 16;
          for (int b = 0; b < n_blocks; ++b) {
            const bool full = b * 16 + 16 <= kx;
            int av[2 * RP][4];
            if (!TRANS && full && vec) {
#pragma unroll
              for (int f = 0; f < 2 * RP; ++f) {
                const char2 lo = *reinterpret_cast<const char2*>(xr[f] + 16 * b + 2 * kk);
                const char2 hi = *reinterpret_cast<const char2*>(xr[f] + 16 * b + 8 + 2 * kk);
                av[f][0] = lo.x; av[f][1] = lo.y; av[f][2] = hi.x; av[f][3] = hi.y;
              }
            } else {
#pragma unroll
              for (int f = 0; f < 2 * RP; ++f)
#pragma unroll
                for (int s = 0; s < 4; ++s) {
                  const int kr = TRANS ? 16 * b + 4 * s + kk
                                       : 16 * b + 2 * kk + (s & 1) + 8 * (s >> 1);
                  av[f][s] = kr < kx ? xr[f][kr] : 0;
                }
            }
#pragma unroll
            for (int s = 0; s < 4; ++s) {
              // transposed: stored row wcol + lrow + 8 j of the strip, its
              // column kr
              const int kr = TRANS ? 16 * b + 4 * s + kk
                                   : 16 * b + 2 * kk + (s & 1) + 8 * (s >> 1);
              const float* grow = TRANS ? gs + gofs[0] + (wcol + lrow) * gp + kr
                                        : gs + kr * gp + gofs[s] + wcol + lrow;
              const int jstep = TRANS ? 8 * gp : 8;
              const bool g_ok = full || kr < kg;
              double bv[GF];
#pragma unroll
              for (int j = 0; j < GF; ++j) bv[j] = g_ok ? (double)grow[jstep * j] : 0.0;
#pragma unroll
              for (int p = 0; p < RP; ++p)
#pragma unroll
                for (int j = 0; j < GF; ++j)
                  dmma(acc[s % NS][p][j], __int2double_rn(av[2 * p][s]),
                       __int2double_rn(av[2 * p + 1][s]), bv[j]);
            }
          }
          __syncthreads();               // stage st read: refill it
          if (more) {
            walk_issue<TRANS>(a, g, maps, cur, ring + st * sbytes, smem_u32(&bars[st]),
                              threadIdx.x);
            more = cursor_next<RUNS>(a, g, cur, n_chunks);
          }
        }

        // tile t's terms, added to the run's partial (one code path per
        // activation: the epilogue's branches fold away)
        switch (e.act) {
          case kNone:     walk_terms<kNone>(e, acc, terms, gt, row0, col0, part); break;
          case kRelu:     walk_terms<kRelu>(e, acc, terms, gt, row0, col0, part); break;
          case kTanh:     walk_terms<kTanh>(e, acc, terms, gt, row0, col0, part); break;
          case kSigmoid:  walk_terms<kSigmoid>(e, acc, terms, gt, row0, col0, part); break;
          case kIdentity: walk_terms<kIdentity>(e, acc, terms, gt, row0, col0, part); break;
          default:        walk_terms<kStochastic>(e, acc, terms, gt, row0, col0, part); break;
        }
      }
#pragma unroll
      for (int i = 0; i < NA; ++i) total[i] = __fadd_rn(total[i], part[i]);
    }
#pragma unroll
    for (int p = 0; p < RP; ++p)
#pragma unroll
      for (int j = 0; j < GF; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int row = m0 + wrow + 16 * p + 8 * (h >> 1) + lrow;
          const int col = c0 + wcol + 8 * j + 2 * kk + (h & 1);
          if (row < a.M && col < a.bn)
            a.out[(size_t)row * out_ld + (size_t)cb * a.bn + col] = total[(p * GF + j) * 4 + h];
        }
  }
}

using WalkKernel = void (*)(WalkArgs, WalkGeometry, Epilogue, WalkMaps);

// The kernel of `layout` (nullptr for none).
template <bool RUNS, bool TRANS>
WalkKernel walk_kernel(int layout) {
  switch (layout) {
    case 0: return cim_walk<2, 4, RUNS, TRANS>;
    case 1: return cim_walk<1, 4, RUNS, TRANS>;
    case 2: return cim_walk<1, 2, RUNS, TRANS>;
    default: return nullptr;
  }
}

// Whether geometry g is one the walk implements for a: a stage holds at
// most 128 of the contraction, or (transposed) all of it up to 256.
inline bool walk_valid(const WalkArgs& a, const WalkGeometry& g, bool trans) {
  if (g.layout < 0 || g.layout >= kWalkLayouts) return false;
  const int kc_max = trans ? 256 : 128;
  return g.bm == kWalkItem[g.layout][0] && g.bn_blk == kWalkItem[g.layout][1] &&
         g.trans == (int)trans && (!trans || a.tile_slot) &&
         a.M >= 1 && a.bk >= 1 && a.bn >= 1 && a.n_col_blocks >= 1 && a.n_tiles >= 1 &&
         g.n_rbk == (a.M + g.bm - 1) / g.bm &&
         g.n_strips == (a.bn + g.bn_blk - 1) / g.bn_blk &&
         g.kc >= 16 && g.kc <= kc_max && g.kc % 16 == 0 &&
         (g.kc <= 128 || g.kc >= a.bk) &&
         g.stages >= 2 && g.stages <= kWalkMaxStages &&
         g.n_items == g.n_rbk * g.n_strips * a.n_col_blocks &&
         (reinterpret_cast<uintptr_t>(a.gd) & 3) == 0;
}

// The dynamic shared memory each layout's kernel may request so far in
// the library that includes this header (`static`: one array per
// library, which launches one walk; a static local of a template would
// be one symbol across every loaded library).
static int walk_smem_allowed[kWalkLayouts];

template <bool RUNS, bool TRANS>
cudaError_t walk_allow(int layout, int smem) {
  int& allowed = walk_smem_allowed[layout];
  if (allowed == 0) allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      walk_kernel<RUNS, TRANS>(layout), cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// The driver's tensor-map encoder, looked up once per library (nullptr
// where the driver has none).
static PFN_cuTensorMapEncodeTiled_v12000 walk_encode_fn;
static bool walk_encode_looked_up;

inline PFN_cuTensorMapEncodeTiled_v12000 walk_encoder() {
  if (!walk_encode_looked_up) {
    walk_encode_looked_up = true;
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      walk_encode_fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  return walk_encode_fn;
}

// A 2-D tensor map of `rows` rows of `cols` elements (`row_bytes` apart)
// at `base`, read in boxes of box_cols x box_rows, zeros past its edges;
// false where the TMA cannot take it (rows off the 16-byte grid).
inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type, const void* base,
                       int cols, int rows, size_t row_bytes, int box_cols, int box_rows) {
  const auto encode = walk_encoder();
  if (!encode || (reinterpret_cast<uintptr_t>(base) & 15) || (row_bytes & 15)) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)row_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t steps[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(base), dims, strides, box, steps,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Launches `grid` blocks of the walk on `stream`; a CUDA error code.
// Transposed, a stage's stored rows come by tensor copy or, where one
// chunk spans the contraction, by one bulk copy; never row by row.
template <bool RUNS, bool TRANS>
int walk_launch(const WalkArgs& a, const WalkGeometry& g, const Epilogue& e,
                int grid, cudaStream_t stream) {
  if (!walk_valid(a, g, TRANS) || grid < 1 ||
      (RUNS && !(a.col_run_start && a.col_runs)))
    return (int)cudaErrorInvalidValue;
  WalkMaps maps = {};
  maps.x_mode = encode_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_UINT8, a.x, a.K, a.M,
                           (size_t)a.K, walk_x_pitch(g.kc), g.bm)
                    ? kCopyTensor : kCopyRows;
  const int n_chunks = (a.bk + g.kc - 1) / g.kc;
  if (TRANS) {
    // gd_tiles as (T * bn) stored rows of bk columns, boxes of the strip's
    // bn_blk rows and the chunk's columns at the stage pitch (at most 256)
    const bool tensor = g.kc <= 128 &&
        encode_map(&maps.gd, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.gd, a.bk,
                   a.n_tiles * a.bn, (size_t)a.bk * 4, walk_g_pitch(g.kc), g.bn_blk);
    if (!tensor && n_chunks > 1) return (int)cudaErrorInvalidValue;
    maps.gd_mode = tensor ? kCopyTensor : kCopyBulk;
  } else {
    maps.gd_mode = encode_map(&maps.gd, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, a.gd, a.bn,
                              a.n_tiles * a.bk, (size_t)a.bn * 4, walk_g_pitch(g.bn_blk),
                              g.kc)
                       ? kCopyTensor : g.n_strips == 1 ? kCopyBulk : kCopyRows;
  }
  const int smem = walk_shared_bytes(g);
  const cudaError_t err = walk_allow<RUNS, TRANS>(g.layout, smem);
  if (err != cudaSuccess) return (int)err;
  walk_kernel<RUNS, TRANS>(g.layout)<<<grid, kWalkThreads, smem, stream>>>(a, g, e, maps);
  return (int)cudaGetLastError();
}

// Blocks of geometry g resident on one SM of the current device, as the
// runtime reports for the layout's registers and g's shared memory; a
// negative CUDA error code on failure.
template <bool RUNS, bool TRANS>
int walk_occupancy(const WalkGeometry& g) {
  if (g.layout < 0 || g.layout >= kWalkLayouts || g.trans != (int)TRANS)
    return -(int)cudaErrorInvalidValue;
  const int smem = walk_shared_bytes(g);
  int occ = 0;
  cudaError_t err = walk_allow<RUNS, TRANS>(g.layout, smem);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, walk_kernel<RUNS, TRANS>(g.layout), kWalkThreads, smem);
  return err == cudaSuccess ? occ : -(int)err;
}

}  // namespace cim

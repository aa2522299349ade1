// Single-matrix NeuRRAM CIM MVM for Hopper (sm_90a), with the per-matrix
// forward's input quantization and output dequantization fused in.
//
// Replaces repro/kernels/cim_mvm/kernel.py::cim_mvm_pallas (the Pallas TPU
// kernel `_cim_kernel` with its `_epilogue`): one programmed matrix,
//   acc    = x @ gd                        over all K rows
//   q      = acc * v_read * inv_norm[n]    (f32, in this order)
//   out    = ADC epilogue of q (charge-decrement rounding + activation:
//            none, relu, tanh, sigmoid, identity, or the stochastic neuron)
// with gd = G+ - G- (K, N) f32, a scalar v_decr (device pointer) and one
// write per output. Two entries share the kernel:
//   * unfused (`cim_mvm`): x (M, K) integer-valued f32, out = the counts.
//   * fused (`cim_forward`, core/cim.forward): x (M, Kx) float patches,
//     quantized as quantize_to_int does, x = clamp(rint(x / scale), -n,
//     n) with scale = in_alpha * (1 / n); the K - Kx bias rows
//     take the constant `bias` (the PACT clip), quantized alike; the
//     epilogue then cancels the ADC offset (activation none) and
//     dequantizes, ((((c * v_decr) * norm) * w_max) * scale) * (1 / D),
//     D = v_read * g_max, one IEEE operation at a time.
//
// What bounds it: on the per-matrix path (im2col'd convolutions of the
// 7-layer CNN and ResNet-20, K <= 577, N <= 64) every x element is used by
// N <= 64 multiply-adds: the stem and stage-0 shapes are bound by the bytes
// of x, the K = 577, N = 64 shapes by the FP64 operations.
//
// What the design does about it:
//   * the dot runs on the FP64 tensor cores (mma.sync m16n8k4 f64,
//     cim_dmma.cuh `dmma`; on an H100 the m8n8k4 shape reaches half the
//     FP64 tensor rate). It is exact in any order and any split of K:
//     x holds integers (|x| <= 127)
//     and gd lies on the 2^-23 grid below 2^6 with K * 127 * max|gd| <
//     2^30 (the verifier's per-matrix `exact-dot`), so the one rounding to
//     f32 equals the plain version's (an FP64 matmul) bit for bit. The
//     kernel uses that freedom: within each 16-row block of K, lane k-slot
//     kk of k-step t holds row 16b + 4kk + t (a lane reads four
//     neighbouring x values with one 16-byte shared load), and each k-step
//     has its own accumulators (more DMMA chains in flight), summed last.
//   * a block's 4 warps each cover 16 * RF / 2 rows and GF of the column
//     tile's 8-column groups (wc warps split a tile's groups); a tile
//     covers up to 64 columns, so on every CNN shape x is read once and no
//     thread idles at N = 16.
//   * gd is resident in shared memory as f32, permuted so that each B
//     fragment is 32 consecutive words (conflict-free), widened to FP64
//     when read; it is loaded row by row with 16-byte loads.
//   * a persistent grid (occupancy x SMs) walks units of (column tile, row
//     chunk, K slice); x streams through a ring of `stages` shared-memory
//     stages, one unit each, filled by 1-D bulk copies (cp.async.bulk,
//     bulk_copy.cuh) on an mbarrier per stage: where one slice covers K,
//     a stage is ONE copy of the chunk's whole rows (contiguous in x);
//     otherwise one copy per row of the slice. A copy moves the 16-byte
//     aligned cover of its bytes and the reader adds the offset mod 16, so
//     rows off the 16-byte grid (K = 10, 145, 577, ...) need no tensor map.
//     The kernel is bound by latencies, not by one unit: the geometry
//     (kernel.mvm_geometry) takes the layout that keeps the most blocks
//     resident per SM, as the runtime reports for its registers and shared
//     memory (`cim_mvm_occupancy`), and where one block fills an SM, a
//     second group of 4 warps takes every other 16-row block of K; its
//     sums reach the first group through the item's last stage. The
//     caller sizes the grid from the same number.
//   * the fused entry quantizes each landed stage in place, every input
//     once, by all the block's threads, before the warps read it.
//   * few units (small M: the fc layers, decode-sized tests) split K over
//     the blocks: each split adds its exact FP64 partial with atomicAdd
//     into a zeroed scratch, the last split of a tile (an arrival counter)
//     runs the epilogue. Exactness makes the order free.
//   * the stochastic neuron hashes at the reference's block-local
//     coordinates (row % bm_ref, col % bn_ref) with salts (seed,
//     row / bm_ref, col / bn_ref), from each accumulator element's own
//     (row, col).
// Shared memory (dynamic): kMvmBarrierBytes + bk * bn * 4 (gd) + stages *
// stage bytes; `cim_mvm_shared_bytes`, kernel.mvm_shared_bytes.
#include "bulk_copy.cuh"
#include "cim_dmma.cuh"
#include "cim_epilogue.cuh"

namespace cim {

// Mirrors kernel.MvmGeometry (ctypes) field for field.
struct MvmGeometry {
  int gf, wc, rf;        // 8-column groups per warp, warps per tile row
                         // block (column split), row fragments per warp
  int bn, n_ct;          // columns per tile (8 * gf * wc), column tiles
  int cr, n_rc;          // rows per chunk ((4 / wc) * 8 * rf), row chunks
  int bk, n_slices;      // K rows per slice (multiple of 16), slices
  int spb, n_ks;         // slices per K split, K splits
  int stages;            // ring stages
  int contiguous;        // 1: one slice covers K; a stage is one copy
  int kg;                // warp groups (1 or 2) splitting each chunk's K
};

// Mirrors kernel.MvmArgs.
struct MvmArgs {
  const float* x;        // (M, Kx)
  int M, K, Kx, N;
  const float* gd;       // (K, N)
  const float* inv_norm; // (N,)
  const float* v_decr;   // 0-d
  int bn_ref;
  float* out;            // (M, N)
  double* partial;       // (M, N) zeroed FP64 scratch of the K splits
  int* arrived;          // (n_ct * n_rc) zeroed arrival counters
  // fused forward only
  const float* in_alpha; // 0-d PACT clip of the layer
  const float* bias;     // 0-d value of the bias rows
  float levels, inv_levels;  // n and 1 / n (f32) of the input grid
  const float* off_counts;   // (N,) round(adc_offset / v_decr)
  const float* norm;         // (N,)
  const float* w_max;        // 0-d
  float inv_out_div;         // 1 / (v_read * g_max) (f32)
};

}  // namespace cim

namespace {

using namespace cim;
using Geometry = MvmGeometry;
using Args = MvmArgs;

constexpr int kMvmWarps = 4;
constexpr int kMvmThreads = 32 * kMvmWarps;
constexpr int kMvmBarrierBytes = 128;   // the stages' mbarriers, padded
constexpr int kMvmMaxStages = 4;
constexpr int kGdBatch = 8;             // gd loads in flight per thread

__host__ __device__ __forceinline__ int round16(int v) { return (v + 15) & ~15; }

// Doubles one warp group's accumulators take: 8 per 16 x 8 output tile.
__host__ __device__ __forceinline__ int group_doubles(const Geometry& g) {
  return kMvmThreads * g.rf * g.gf * 2;
}

// A stage holds the unit's x, and with two warp groups also the second
// group's accumulators at the end of an item.
__host__ __device__ __forceinline__ int stage_bytes(const Geometry& g, int kx) {
  const int x = g.contiguous ? round16(g.cr * kx * 4) + 16 : g.cr * (g.bk * 4 + 16);
  return g.kg == 2 ? max(x, group_doubles(g) * 8) : x;
}

__host__ __device__ __forceinline__ int mvm_shared_bytes(const Geometry& g, int kx) {
  return kMvmBarrierBytes + g.bk * g.bn * 4 + g.stages * stage_bytes(g, kx);
}

// The unit (column tile, row chunk, slice) of item `item`, slice `s`.
struct Unit { int ct, rc, ks, slice; };

__device__ __forceinline__ Unit unit_of(const Geometry& g, int item, int s) {
  const int per_ct = g.n_rc * g.n_ks;
  Unit u;
  u.ct = item / per_ct;
  const int r = item - u.ct * per_ct;
  u.rc = r / g.n_ks;
  u.ks = r - u.rc * g.n_ks;
  u.slice = u.ks * g.spb + s;
  return u;
}

__device__ __forceinline__ int slices_of(const Geometry& g, int ks) {
  return min(g.spb, g.n_slices - ks * g.spb);
}

// Start unit u's x copies into stage `st` (thread 0 only): one copy of the
// chunk's whole rows, or one per row of the slice; each copy the 16-byte
// aligned cover of its bytes.
__device__ __forceinline__ void copy_unit(const Args& a, const Geometry& g,
                                          const Unit& u, unsigned char* stage,
                                          uint32_t bar) {
  const int r0 = u.rc * g.cr, rows = min(g.cr, a.M - r0);
  const uintptr_t base = reinterpret_cast<uintptr_t>(a.x);
  if (g.contiguous) {
    const uintptr_t src = base + (uintptr_t)r0 * a.Kx * 4;
    const uintptr_t lo = src & ~(uintptr_t)15;
    const uint32_t bytes = (uint32_t)(((src + (uintptr_t)rows * a.Kx * 4 + 15) & ~(uintptr_t)15) - lo);
    mbar_expect_tx(bar, bytes);
    if (bytes) bulk_load(smem_u32(stage), reinterpret_cast<const void*>(lo), bytes, bar);
    return;
  }
  const int k0 = u.slice * g.bk, len = min(g.bk, a.Kx - k0);
  if (len <= 0) { mbar_expect_tx(bar, 0); return; }
  uint32_t total = 0;
  for (int r = 0; r < rows; ++r) {
    const uintptr_t src = base + ((uintptr_t)(r0 + r) * a.Kx + k0) * 4;
    total += (uint32_t)(((src + (uintptr_t)len * 4 + 15) & ~(uintptr_t)15) - (src & ~(uintptr_t)15));
  }
  mbar_expect_tx(bar, total);
  const int rs = g.bk * 4 + 16;
  for (int r = 0; r < rows; ++r) {
    const uintptr_t src = base + ((uintptr_t)(r0 + r) * a.Kx + k0) * 4;
    const uintptr_t lo = src & ~(uintptr_t)15;
    const uint32_t bytes = (uint32_t)(((src + (uintptr_t)len * 4 + 15) & ~(uintptr_t)15) - lo);
    bulk_load(smem_u32(stage + r * rs), reinterpret_cast<const void*>(lo), bytes, bar);
  }
}

// quantize_to_int's clamp(round(x / scale)) of one input. The product q0
// by the f32 reciprocal of scale lies within 2^-22 |x / scale| of the IEEE
// quotient, so below |q0| = 128 both round to the same integer unless q0
// lies within 2^-13 of a .5 tie; only then is the quotient itself taken.
// Above, both clamp to the same bound.
__device__ __forceinline__ float quantize(float v, float scale, float inv_scale,
                                          float levels) {
  const float q0 = __fmul_rn(v, inv_scale);
  float r = rintf(q0);
  if (fabsf(__fsub_rn(q0, r)) >= 0.5f - 0x1p-13f) r = rintf(__fdiv_rn(v, scale));
  return fminf(fmaxf(r, -levels), levels);
}

// The output of one accumulator element (row, c).
template <bool FUSED>
__device__ __forceinline__ void store(const Args& a, const Epilogue& e,
                                      double acc, int row, int c, float vd,
                                      float scale, float w_max) {
  if (row >= a.M || c >= a.N) return;
  const float q = __fmul_rn(__fmul_rn(__double2float_rn(acc), e.v_read), a.inv_norm[c]);
  float v;
  if (!FUSED && e.act == kStochastic) {
    v = stochastic_bit(q, vd, (uint32_t)(row % e.bm_ref), (uint32_t)(c % a.bn_ref),
                       (uint32_t)(row / e.bm_ref), (uint32_t)(c / a.bn_ref), e);
  } else {
    v = adc(q, vd, e);
  }
  if (FUSED) {
    if (e.act == kNone) v = __fsub_rn(v, a.off_counts[c]);
    if (e.act != kTanh && e.act != kSigmoid)
      v = __fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(__fmul_rn(v, vd), a.norm[c]), w_max),
                              scale), a.inv_out_div);
  }
  a.out[(size_t)row * a.N + c] = v;
}

// At least one block per SM: the registers a thread may take are not
// capped below what the accumulators need (a tighter cap spills).
template <int GF, int RF, int KG, bool FUSED>
__global__ void __launch_bounds__(kMvmThreads * KG, 1)
cim_mvm_kernel(Args a, Geometry g, Epilogue e) {
  constexpr int NT = kMvmThreads * KG;
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  float* gs = reinterpret_cast<float*>(smem + kMvmBarrierBytes);
  unsigned char* ring = smem + kMvmBarrierBytes + g.bk * g.bn * 4;
  const int sbytes = stage_bytes(g, a.Kx);
  __shared__ int last_split;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kk = lane & 3, lrow = lane >> 2;
  // warp group (each takes every KG-th 16-row block of K), row block,
  // column part
  const int kgrp = warp / kMvmWarps, w4 = warp % kMvmWarps;
  const int wr = w4 / g.wc, wcol = w4 % g.wc;
  const int groups = g.bn / 8;
  const int n_items = g.n_ct * g.n_rc * g.n_ks;
  const float vd = *a.v_decr;
  float scale = 0.f, inv_scale = 0.f, w_max = 0.f;
  double qbias = 0.0;
  if (FUSED) {
    scale = __fmul_rn(*a.in_alpha, a.inv_levels);
    inv_scale = __frcp_rn(scale);
    qbias = (double)quantize(*a.bias, scale, inv_scale, a.levels);
    w_max = *a.w_max;
  }

  if (threadIdx.x == 0) {
    for (int s = 0; s < g.stages; ++s) mbar_init(smem_u32(&bars[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the producer's cursor (thread 0): item index j of this block, slice s
  int pj = 0, ps = 0;
  auto produce = [&](int stage_slot) {
    const int item = blockIdx.x + pj * gridDim.x;
    if (item >= n_items) return false;
    const Unit u = unit_of(g, item, ps);
    copy_unit(a, g, u, ring + stage_slot * sbytes, smem_u32(&bars[stage_slot]));
    if (++ps == slices_of(g, u.ks)) { ps = 0; ++pj; }
    return true;
  };
  if (threadIdx.x == 0)
    for (int s = 0; s < g.stages; ++s) produce(s);

  int loaded_ct = -1, loaded_slice = -1;
  constexpr int RP = RF / 2;          // 16-row fragment pairs per warp
  // independent accumulator sets, one per k-step of a 16-row block of K
  // (up to 4): more DMMA chains in flight; summed at the item's end
  constexpr int NS = RP * GF >= 4 ? 2 : 4;
  double acc[NS][RP][GF][4];
  int unit_no = 0;
  for (int item = blockIdx.x; item < n_items; item += gridDim.x) {
    const Unit first = unit_of(g, item, 0);
    const int n_s = slices_of(g, first.ks);
    const int r0 = first.rc * g.cr, rows = min(g.cr, a.M - r0);
#pragma unroll
    for (int q = 0; q < NS; ++q)
#pragma unroll
      for (int f = 0; f < RP; ++f)
#pragma unroll
        for (int j = 0; j < GF; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h) acc[q][f][j][h] = 0.0;

    for (int s = 0; s < n_s; ++s, ++unit_no) {
      const int slice = first.slice + s;
      const int k0 = slice * g.bk;
      const int klen = min(g.bk, a.K - k0), kxlen = min(g.bk, a.Kx - k0);
      if (first.ct != loaded_ct || slice != loaded_slice) {
        // gd[k0 : k0 + bk, tile columns], permuted: word ((b * 4 + t) *
        // groups + grp) * 32 + lane holds row 16b + 4 (lane & 3) + t,
        // column 8 grp + (lane >> 2); zero past K and N
        // read row by row (coalesced, kGdBatch loads in flight per thread;
        // 16-byte loads where gd's rows allow)
        const int c0 = first.ct * g.bn;
        const int lbn = __ffs(g.bn) - 1, n_gd = g.bk * g.bn;
        auto gs_at = [&](int k, int c) -> float& {
          return gs[(((k >> 4) * 4 + (k & 3)) * groups + (c >> 3)) * 32 + (c & 7) * 4 +
                    ((k >> 2) & 3)];
        };
        const bool gd_vec = (a.N & 3) == 0 && (reinterpret_cast<uintptr_t>(a.gd) & 15) == 0;
        for (int i0 = threadIdx.x; gd_vec && i0 < n_gd / 4; i0 += kGdBatch * NT) {
          float4 v[kGdBatch];
#pragma unroll
          for (int u = 0; u < kGdBatch; ++u) {
            const int i = (i0 + u * NT) * 4;
            const int k = i >> lbn, c = c0 + (i & (g.bn - 1));
            v[u] = (i < n_gd && k < klen && c < a.N)
                       ? __ldg(reinterpret_cast<const float4*>(a.gd + (size_t)(k0 + k) * a.N + c))
                       : make_float4(0.f, 0.f, 0.f, 0.f);
          }
#pragma unroll
          for (int u = 0; u < kGdBatch; ++u) {
            const int i = (i0 + u * NT) * 4;
            const int k = i >> lbn, c = i & (g.bn - 1);
            if (i < n_gd) {
              gs_at(k, c) = v[u].x;
              gs_at(k, c + 1) = v[u].y;
              gs_at(k, c + 2) = v[u].z;
              gs_at(k, c + 3) = v[u].w;
            }
          }
        }
        for (int i0 = threadIdx.x; !gd_vec && i0 < n_gd; i0 += kGdBatch * NT) {
          float v[kGdBatch];
#pragma unroll
          for (int u = 0; u < kGdBatch; ++u) {
            const int i = i0 + u * NT;
            const int k = i >> lbn, c = c0 + (i & (g.bn - 1));
            v[u] = (i < n_gd && k < klen && c < a.N)
                       ? __ldg(a.gd + (size_t)(k0 + k) * a.N + c) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < kGdBatch; ++u) {
            const int i = i0 + u * NT;
            const int k = i >> lbn, c = i & (g.bn - 1);
            if (i < n_gd) gs_at(k, c) = v[u];
          }
        }
        __syncthreads();
        loaded_ct = first.ct;
        loaded_slice = slice;
      }
      const int st = unit_no % g.stages;
      mbar_wait(smem_u32(&bars[st]), (uint32_t)((unit_no / g.stages) & 1));
      unsigned char* stage = ring + st * sbytes;
      if (FUSED && kxlen > 0) {
        // quantize the stage's inputs in place, each once, by every thread
        if (g.contiguous) {
          // the stage from its 16-byte aligned start, four values a load
          // (the cover's bytes before x's first and after its last are
          // quantized too, and never read)
          float4* p = reinterpret_cast<float4*>(stage);
          const int shift = (int)((reinterpret_cast<uintptr_t>(a.x) + (uintptr_t)r0 * a.Kx * 4) & 15);
          const int n4 = (shift + rows * a.Kx * 4 + 15) >> 4;
          for (int i = threadIdx.x; i < n4; i += NT) {
            float4 w = p[i];
            w.x = quantize(w.x, scale, inv_scale, a.levels);
            w.y = quantize(w.y, scale, inv_scale, a.levels);
            w.z = quantize(w.z, scale, inv_scale, a.levels);
            w.w = quantize(w.w, scale, inv_scale, a.levels);
            p[i] = w;
          }
        } else {
          const int n_x = rows * kxlen;
          for (int i = threadIdx.x; i < n_x; i += NT) {
            const int r = i / kxlen, c = i - r * kxlen;
            const uintptr_t src = reinterpret_cast<uintptr_t>(a.x) +
                                  ((uintptr_t)(r0 + r) * a.Kx + k0) * 4;
            float* p = reinterpret_cast<float*>(stage + r * (g.bk * 4 + 16) + (src & 15)) + c;
            *p = quantize(*p, scale, inv_scale, a.levels);
          }
        }
        __syncthreads();
      }

      // this lane's x rows in the stage (a row past M reads row 0: its
      // outputs are never stored)
      const unsigned char* rowp[RF];
      bool vec = true;
#pragma unroll
      for (int f = 0; f < RF; ++f) {
        int lr = wr * 8 * RF + 8 * f + lrow;
        lr = lr < rows ? lr : 0;
        const uintptr_t src = reinterpret_cast<uintptr_t>(a.x) +
                              ((uintptr_t)(r0 + lr) * a.Kx + k0) * 4;
        if (g.contiguous) {
          const uintptr_t shift = (reinterpret_cast<uintptr_t>(a.x) +
                                   (uintptr_t)r0 * a.Kx * 4) & 15;
          rowp[f] = stage + shift + (size_t)lr * a.Kx * 4;
        } else {
          rowp[f] = stage + lr * (g.bk * 4 + 16) + (src & 15);
        }
        vec = vec && ((reinterpret_cast<uintptr_t>(rowp[f]) & 15) == 0);
      }
      vec = __all_sync(0xffffffffu, vec);

      const int n_blocks = (klen + 15) / 16;
      for (int b = kgrp; b < n_blocks; b += KG) {
        const int kb = b * 16 + 4 * kk;          // this lane's first k
        double av[RF][4];
        if (b * 16 + 16 <= kxlen) {
#pragma unroll
          for (int f = 0; f < RF; ++f) {
            float v[4];
            if (vec) {
              const float4 w = *reinterpret_cast<const float4*>(rowp[f] + kb * 4);
              v[0] = w.x; v[1] = w.y; v[2] = w.z; v[3] = w.w;
            } else {
              const float* p = reinterpret_cast<const float*>(rowp[f]) + kb;
#pragma unroll
              for (int t = 0; t < 4; ++t) v[t] = p[t];
            }
#pragma unroll
            for (int t = 0; t < 4; ++t) av[f][t] = (double)v[t];
          }
        } else {                                  // the slice's ragged end
#pragma unroll
          for (int f = 0; f < RF; ++f) {
            const float* p = reinterpret_cast<const float*>(rowp[f]);
#pragma unroll
            for (int t = 0; t < 4; ++t) {
              const int k = kb + t;
              av[f][t] = k < kxlen ? (double)p[k] : (k < klen ? qbias : 0.0);
            }
          }
        }
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          double bv[GF];
#pragma unroll
          for (int j = 0; j < GF; ++j)
            bv[j] = (double)gs[((b * 4 + t) * groups + wcol * GF + j) * 32 + lane];
#pragma unroll
          for (int f = 0; f < RP; ++f)
#pragma unroll
            for (int j = 0; j < GF; ++j)
              dmma(acc[t % NS][f][j], av[2 * f][t], av[2 * f + 1][t], bv[j]);
        }
      }
      __syncthreads();                 // stage st read
      if (KG == 2 && s == n_s - 1) {
        // the item's last unit: the sets' sums (exact in any order), the
        // second group's through the stage just read, then its refill
        double* red = reinterpret_cast<double*>(stage);
        int v = 0;
#pragma unroll
        for (int f = 0; f < RP; ++f)
#pragma unroll
          for (int j = 0; j < GF; ++j)
#pragma unroll
            for (int h = 0; h < 4; ++h, ++v) {
              double sum = acc[0][f][j][h];
#pragma unroll
              for (int q = 1; q < NS; ++q) sum += acc[q][f][j][h];
              acc[0][f][j][h] = sum;
              if (kgrp == 1) red[v * kMvmThreads + w4 * 32 + lane] = sum;
            }
        __syncthreads();
        v = 0;
#pragma unroll
        for (int f = 0; f < RP; ++f)
#pragma unroll
          for (int j = 0; j < GF; ++j)
#pragma unroll
            for (int h = 0; h < 4; ++h, ++v)
              if (kgrp == 0) acc[0][f][j][h] += red[v * kMvmThreads + w4 * 32 + lane];
        __syncthreads();
      }
      if (threadIdx.x == 0) produce(st);
    }

    // the item's outputs (group 0): row r0 + wr*8*RF + 16f + 8 (h / 2) +
    // lane/4, columns c0 + 8 (wcol*GF + j) + 2 (lane % 4) + {0, 1}
    if (KG == 1) {
#pragma unroll
      for (int q = 1; q < NS; ++q)
#pragma unroll
        for (int f = 0; f < RP; ++f)
#pragma unroll
          for (int j = 0; j < GF; ++j)
#pragma unroll
            for (int h = 0; h < 4; ++h) acc[0][f][j][h] += acc[q][f][j][h];
    }
    const bool owner = kgrp == 0;
    const int c0 = first.ct * g.bn;
    if (g.n_ks == 1) {
      if (!owner) continue;
#pragma unroll
      for (int f = 0; f < RP; ++f)
#pragma unroll
        for (int j = 0; j < GF; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h)
            store<FUSED>(a, e, acc[0][f][j][h], r0 + wr * 8 * RF + 16 * f + 8 * (h >> 1) + lrow,
                         c0 + 8 * (wcol * GF + j) + 2 * kk + (h & 1), vd, scale, w_max);
      continue;
    }
#pragma unroll
    for (int f = 0; f < RP; ++f)
#pragma unroll
      for (int j = 0; j < GF; ++j)
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int row = r0 + wr * 8 * RF + 16 * f + 8 * (h >> 1) + lrow;
          const int c = c0 + 8 * (wcol * GF + j) + 2 * kk + (h & 1);
          if (owner && row < a.M && c < a.N)
            atomicAdd(a.partial + (size_t)row * a.N + c, acc[0][f][j][h]);
        }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0)
      last_split = atomicAdd(a.arrived + first.ct * g.n_rc + first.rc, 1) == g.n_ks - 1;
    __syncthreads();
    if (last_split && owner) {
      __threadfence();
#pragma unroll
      for (int f = 0; f < RP; ++f)
#pragma unroll
        for (int j = 0; j < GF; ++j)
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const int row = r0 + wr * 8 * RF + 16 * f + 8 * (h >> 1) + lrow;
            const int c = c0 + 8 * (wcol * GF + j) + 2 * kk + (h & 1);
            if (row < a.M && c < a.N)
              store<FUSED>(a, e, __ldcg(a.partial + (size_t)row * a.N + c), row, c,
                           vd, scale, w_max);
          }
    }
  }
}

// The dynamic shared memory each instantiation may request so far in this
// library (a file-scope array: a static local of a template would be one
// GNU-unique symbol across every loaded library).
static int mvm_smem_allowed[2][2][5];

// Lets instantiation (GF, RF, KG, FUSED), `slot` its (GF, RF) index,
// request smem bytes of dynamic shared memory.
template <int GF, int RF, int KG, bool FUSED>
cudaError_t allow_smem(int slot, int smem) {
  int& allowed = mvm_smem_allowed[KG - 1][FUSED][slot];
  if (allowed == 0) allowed = 48 * 1024;
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      cim_mvm_kernel<GF, RF, KG, FUSED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// The instantiation a geometry selects, as a class of two entries.
template <int GF, int RF, int KG, bool FUSED>
struct Instance {
  // Blocks of geometry g (x of kx columns) resident on one SM of the
  // current device, as the runtime reports for this instantiation's
  // registers and g's shared memory; a negative CUDA error code on failure.
  static int occupancy(int slot, const Geometry& g, int kx) {
    const int smem = mvm_shared_bytes(g, kx);
    int occ = 0;
    cudaError_t err = allow_smem<GF, RF, KG, FUSED>(slot, smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occ, cim_mvm_kernel<GF, RF, KG, FUSED>, kMvmThreads * KG, smem);
    return err == cudaSuccess ? occ : -(int)err;
  }

  // Launches `grid` blocks on `stream`; returns a CUDA error code.
  static int launch(int slot, const Args& a, const Geometry& g, const Epilogue& e, int grid,
                    cudaStream_t stream) {
    const int smem = mvm_shared_bytes(g, a.Kx);
    const cudaError_t err = allow_smem<GF, RF, KG, FUSED>(slot, smem);
    if (err != cudaSuccess) return (int)err;
    cim_mvm_kernel<GF, RF, KG, FUSED><<<grid, kMvmThreads * KG, smem, stream>>>(a, g, e);
    return (int)cudaGetLastError();
  }
};

// Runs F on the instantiation of (g.gf, g.rf, g.kg, fused); `bad` where
// the kernel has none.
template <class F>
int dispatch(const Geometry& g, int fused, int bad, F&& f) {
#define CIM_MVM_CASE(GF_, RF_, SLOT_)                                      \
  if (g.gf == GF_ && g.rf == RF_) {                                       \
    if (g.kg == 2)                                                        \
      return fused ? f(Instance<GF_, RF_, 2, true>(), SLOT_)              \
                   : f(Instance<GF_, RF_, 2, false>(), SLOT_);            \
    return fused ? f(Instance<GF_, RF_, 1, true>(), SLOT_)                \
                 : f(Instance<GF_, RF_, 1, false>(), SLOT_);              \
  }
  CIM_MVM_CASE(1, 4, 0)
  CIM_MVM_CASE(1, 2, 1)
  CIM_MVM_CASE(2, 4, 2)
  CIM_MVM_CASE(2, 2, 3)
  CIM_MVM_CASE(4, 2, 4)
#undef CIM_MVM_CASE
  return bad;
}

// Whether geometry g is one the kernel implements, for x of Kx columns.
bool valid(const Args& a, const Geometry& g) {
  return g.gf >= 1 && g.wc >= 1 && kMvmWarps % g.wc == 0 && g.rf >= 2 &&
         g.rf % 2 == 0 && (g.bn & (g.bn - 1)) == 0 && g.bn == 8 * g.gf * g.wc && g.n_ct == (a.N + g.bn - 1) / g.bn &&
         g.cr == (kMvmWarps / g.wc) * 8 * g.rf &&
         g.n_rc == (a.M + g.cr - 1) / g.cr && g.bk > 0 && g.bk % 16 == 0 &&
         g.n_slices == (a.K + g.bk - 1) / g.bk && g.spb >= 1 &&
         g.n_ks == (g.n_slices + g.spb - 1) / g.spb &&
         (g.n_ks == 1 || (a.partial && a.arrived)) &&
         g.stages >= 2 && g.stages <= kMvmMaxStages &&
         (!g.contiguous || g.n_slices == 1) && (g.kg == 1 || g.kg == 2) && a.Kx <= a.K &&
         (reinterpret_cast<uintptr_t>(a.x) & 3) == 0;
}

}  // namespace

extern "C" {

// Launches `grid` blocks of the kernel on `stream` (fused: the forward's
// quantize and dequantize); returns a CUDA error code (0 = launched).
int cim_mvm_launch(const Args* a, const Geometry* g, const cim::Epilogue* e,
                   int fused, int grid, void* stream) {
  if (!valid(*a, *g) || grid < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return dispatch(*g, fused, (int)cudaErrorInvalidValue, [&](auto inst, int slot) {
    return decltype(inst)::launch(slot, *a, *g, *e, grid, s);
  });
}

// Blocks of geometry g (x of kx columns, fused or not) resident on one SM
// of the current device (0: it cannot launch); a negative CUDA error code
// on failure. kernel.mvm_geometry ranks its tilings by this number.
int cim_mvm_occupancy(const Geometry* g, int kx, int fused) {
  return dispatch(*g, fused, 0, [&](auto inst, int slot) {
    return decltype(inst)::occupancy(slot, *g, kx);
  });
}

// Dynamic shared memory of one block of geometry g with x of kx columns.
int cim_mvm_shared_bytes(const Geometry* g, int kx) {
  return mvm_shared_bytes(*g, kx);
}

}  // extern "C"

// Shared device code of the NeuRRAM CIM MVM kernels for Hopper (sm_90a):
// the ADC epilogue and the stochastic neuron (its hash PRNG is
// kernels/csrc/hash_prng.cuh). Included by cim_walk.cuh, cim_split.cuh and
// cim_mvm.cu.
//
// Ports repro/kernels/cim_mvm/kernel.py `_epilogue`, `_acc_weight` and
// `_pwl_tanh`.
// Every f32 step is one IEEE rounding written out (__fmul_rn, __fadd_rn,
// __fdiv_rn), so no multiply-add contracts and the results equal the
// plain PyTorch versions in kernel.py bit for bit.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hash_prng.cuh"

namespace cim {

enum Activation { kNone = 0, kRelu = 1, kTanh = 2, kSigmoid = 3,
                  kIdentity = 4, kStochastic = 5 };

// Mirrors kernel.Epilogue (ctypes) field for field.
struct Epilogue {
  int act;
  float v_read, n_max, n_max4;
  float k0, k1, k2, st0, st1, st2;  // PWL tanh knots (f32, as the reference)
  uint32_t seed;                    // stochastic: the reference's seed salt
  int bm_ref;                       // stochastic: the reference's batch block
};

// The ADC's charge-decrement steps of q, floor(|q| / vd + 0.5) with the
// reference's two f32 roundings.
__device__ __forceinline__ float adc_steps(float q, float vd) {
  return floorf(__fadd_rn(__fdiv_rn(fabsf(q), vd), 0.5f));
}

// The ADC count of q's `steps` with the fused activation (neither
// identity nor the stochastic neuron).
__device__ __forceinline__ float adc_count(float q, float steps, const Epilogue& e) {
  const float sign = (float)((q > 0.f) - (q < 0.f));
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

// ADC charge-decrement count with the fused activation (not stochastic).
__device__ __forceinline__ float adc(float q, float vd, const Epilogue& e) {
  if (e.act == kIdentity) return q;
  return adc_count(q, adc_steps(q, vd), e);
}

// The stochastic neuron: the comparator bit of q plus uniform noise in
// +-(vd * n_max), the noise drawn by hash_uniform at the reference's
// block-local (row, col) with salts (seed, s1, s2).
__device__ __forceinline__ float stochastic_bit(float q, float vd,
                                               uint32_t row, uint32_t col,
                                               uint32_t s1, uint32_t s2,
                                               const Epilogue& e) {
  const float u01 = prng::to_uniform(prng::bits3(row, col, e.seed, s1, s2));
  const float u = __fsub_rn(__fmul_rn(u01, 2.f), 1.f);
  return __fadd_rn(q, __fmul_rn(u, __fmul_rn(vd, e.n_max))) > 0.f ? 1.f : 0.f;
}

// One tile's contribution to one output: the count times its digital
// accumulation weight. row: the output's row in x; col: its column inside
// the tile's output block; tile: the hash's tile salt (the slot, or the
// stack position for the transposed kernel). The stochastic neuron's bit
// is weighted by the valid-column mask (inv > 0), as the reference's
// `_acc_weight`, and hashed at (row % bm_ref, col) with salts (seed,
// row / bm_ref, tile).
__device__ __forceinline__ float tile_term(float q, float vd, float inv,
                                           float den, int row, int col,
                                           int tile, const Epilogue& e) {
  if (e.act != kStochastic) return __fmul_rn(adc(q, vd, e), den);
  const float bit = stochastic_bit(q, vd, (uint32_t)(row % e.bm_ref),
                                   (uint32_t)col, (uint32_t)(row / e.bm_ref),
                                   (uint32_t)tile, e);
  return inv > 0.f ? bit : 0.f;
}

}  // namespace cim

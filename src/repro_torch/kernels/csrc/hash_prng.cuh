// Counter-based hash PRNG of the port's kernels, as device code: ports
// repro/kernels/prng.py `hash_bits`, `hash_uniform` and `hash_normal`.
//
// A Murmur3 finalizer over block-local element coordinates (row, col) and
// integer salts, in uint32 wraparound: salt k enters as
// h = mix(h + salt * (0x6C62272E + 2k)). Every f32 step is one IEEE
// rounding written out, so the bits and uniforms equal the plain versions
// in kernels/prng.py; the normal's logf / cosf / sqrtf are the precise
// CUDA functions (no fast math), within a few ulps of PyTorch's and XLA's.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace prng {

// Murmur3 finalizer (prng._mix).
__device__ __forceinline__ uint32_t mix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  return h ^ (h >> 16);
}

// The hash state at (row, col) before any salt.
__device__ __forceinline__ uint32_t start(uint32_t row, uint32_t col) {
  return row * 0x9E3779B9u + col * 0x7F4A7C15u;
}

// Folds in salt number k.
__device__ __forceinline__ uint32_t salt(uint32_t h, uint32_t s, uint32_t k) {
  return mix(h + s * (0x6C62272Eu + 2u * k));
}

// hash_bits at (row, col) with three salts.
__device__ __forceinline__ uint32_t bits3(uint32_t row, uint32_t col,
                                          uint32_t s0, uint32_t s1,
                                          uint32_t s2) {
  return mix(salt(salt(salt(start(row, col), s0, 0), s1, 1), s2, 2));
}

// uint32 bits -> f32 in [0, 1]: the conversion rounds to nearest, then an
// exact scale by 2^-32 (hash_uniform).
__device__ __forceinline__ float to_uniform(uint32_t bits) {
  return __fmul_rn(__uint2float_rn(bits), 2.3283064365386963e-10f);
}

// hash_normal at (row, col) with salts (s0, s1, s2): Box-Muller on the
// uniforms of the salt lists (s0, s1, s2, 1) and (s0, s1, s2, 2),
// sqrt(-2 log max(u1, 1e-7)) * cos(2 pi u2).
__device__ __forceinline__ float normal3(uint32_t row, uint32_t col,
                                         uint32_t s0, uint32_t s1,
                                         uint32_t s2) {
  const uint32_t h = salt(salt(salt(start(row, col), s0, 0), s1, 1), s2, 2);
  const float u1 = fmaxf(to_uniform(mix(salt(h, 1u, 3))), 1e-7f);
  const float u2 = to_uniform(mix(salt(h, 2u, 3)));
  const float r = sqrtf(__fmul_rn(-2.0f, logf(u1)));
  return __fmul_rn(r, cosf(__fmul_rn(6.28318530717958647692f, u2)));
}

}  // namespace prng

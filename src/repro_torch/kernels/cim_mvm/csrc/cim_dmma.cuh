// The FP64 tensor-core product the NeuRRAM CIM kernels for Hopper
// (sm_90a) build their exact tile dots from: included by cim_mvm.cu and
// cim_walk.cuh.
//
// x holds integers (|x| <= 127) and gd lies on the 2^-23 grid below 2^6,
// with every partial sum below 2^30 grid steps (the verifier's
// `exact-dot`), so an FP64 sum of their products is exact in any order
// and any split of k. The kernels use that freedom to permute k inside
// each 16-row block of k as their shared-memory layouts read best.
#pragma once

namespace cim {

// D = A B + D for a 16 x 4 A (rows lane / 4 and lane / 4 + 8, column
// lane % 4), a 4 x 8 B (row lane % 4, column lane / 4) and a 16 x 8 D
// (rows as A, columns 2 (lane % 4) + {0, 1}).
__device__ __forceinline__ void dmma(double (&d)[4], double a0, double a1, double b) {
  asm(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3]) : "d"(a0), "d"(a1), "d"(b));
}

}  // namespace cim

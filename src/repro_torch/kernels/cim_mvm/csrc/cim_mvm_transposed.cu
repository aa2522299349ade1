// Transpose-direction (BL->SL) whole-layer NeuRRAM CIM MVM for Hopper
// (sm_90a).
//
// Replaces repro/kernels/cim_mvm/kernel.py:466 cim_mvm_transposed_pallas
// (the Pallas TPU kernel `_cim_transposed_kernel` and `_fold_runs`): the
// TNSA read of the SAME programmed cells with the wire roles swapped. The
// forward stack gd_tiles (T, bko, bni) is shared, never copied: slot t of
// this direction reads stack entry tile_slot[t] and contracts it on its
// stored COLUMN axis,
//   q      = x[:, in_block[t]] @ gd_tiles[tile_slot[t]]^T * v_read * inv[t]
//   counts = ADC epilogue of q, weighted by denorm[t] (per-ROW tensors)
// with the scheduled kernel's runs: each run sums from zero in slot
// order, the runs of an output block fold in run order. Output blocks are
// forward row blocks (bko outputs each), the input is forward columns.
// The stochastic neuron keys its hash on the tile's stack position.
//
// What bounds it: the bytes of the live tiles at small batch (a
// full-width gemma2-9b w_g bwd reads 205 MB of them), the FP64 rate at
// large batch; at the RBM's geometry (795 x 121, 7 tiles) launch latency.
//
// The tile dot is exact in FP64 (|x| <= 127, gd on the 2^-23 grid: the
// verifier's `exact-dot`), so only the fold needs an order, and the
// kernel is the forward kernels' walk (cim_walk.cuh, TRANS) at every M:
// the tile dots on the FP64 tensor cores, a stage holding an item's strip
// of stored rows (its outputs) over a chunk of the stored columns, by
// tensor copy at a conflict-free pitch, or by one bulk copy where the
// stored rows are off the 16-byte grid (the RBM's 121 and 33 columns, the
// IR-drop chip's 47) and one chunk spans them. It has no split route: the
// only path that launches it is the RBM's h->v read, where the walk beat
// a transposed term pass at 4 and 16 rows on an H100. Shared memory
// (dynamic): `walk_shared_bytes`.
#include "cim_epilogue.cuh"
#include "cim_walk.cuh"

extern "C" {

// Launches the transposed walk, `grid` blocks, on `stream` (a->bk: the
// stored columns, a->bn: the stored rows; a->tile_slot required); returns
// a CUDA error code (0 = launched).
int cim_mvm_transposed_launch(const cim::WalkArgs* a, const cim::WalkGeometry* g,
                              const cim::Epilogue* e, int grid, void* stream) {
  return cim::walk_launch<true, true>(*a, *g, *e, grid,
                                      static_cast<cudaStream_t>(stream));
}

// Walk blocks of geometry g resident on one SM of the current device (a
// negative CUDA error code on failure).
int cim_mvm_transposed_occupancy(const cim::WalkGeometry* g) {
  return cim::walk_occupancy<true, true>(*g);
}

// Dynamic shared memory of one walk block of geometry g.
int cim_mvm_transposed_shared_bytes(const cim::WalkGeometry* g) {
  return cim::walk_shared_bytes(*g);
}

}  // extern "C"

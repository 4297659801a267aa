// Chain-batched BART Gibbs sweep for Hopper (sm_90a).
//
// Replaces the TPU kernel stan4bart_tpu/ops/bart_sweep_kernel.py:
// _sweep_call_batch (body _make_batch_kernel, per-tree math
// _tree_step_math).  Each chain is one cluster of K thread blocks that
// splits its observations into K ranges and loops over all T trees; per
// tree it makes one grow/prune/change Metropolis-Hastings step from six
// pre-drawn uniforms, draws the conjugate leaf values from pre-drawn
// normals, and updates the tree's leaf indices, its fitted values and the
// running residual.  The kernel draws no random numbers, so it and its
// plain PyTorch version (ops/bart.py:tree_step) consume identical
// variates.  The sweep itself is sweep_on_chip (sweep_cluster.cuh), shared
// with the obs-tiled kernel; the per-tree steps and their fixed-order sums
// are in sweep_common.cuh.
//
// With p_regrow > 0 each tree's move is followed, where the tree's gate
// uniform falls under p_regrow, by a subtree-regrow Metropolis-Hastings
// move (the JAX package's XLA-only stan4bart_tpu/ops/bart.py:
// _subtree_regrow; sweep_cluster.cuh:regrow_on_chip): a prior draw of
// eta's subtree from 3 + 3 M more pre-drawn uniforms, one pass over the
// observations under eta into a second exact histogram, and the decision
// from both partitions' sums.  With p_regrow == 0 the move costs one
// compare per tree and the forests are those without it, to the bit.
//
// What bounds it: per (chain, tree) it reads leaf_idx, tree_fit and one
// cut-rank row (shared by every chain, so it stays in L2) and writes
// leaf_idx and tree_fit: about 16 bytes of device memory per observation,
// a memory-bound stream.  Everything else stays on chip: each block's
// slice of the running residual (4 B per observation) and a byte copy of
// its leaf indices live in shared memory for the whole sweep, so each
// observation's device-memory bytes are touched once per tree.  A block
// that loads as it computes is bound by load latency and by the serial
// per-tree decision, not by bytes, so the operands stream through a ring
// of tiles with the next tree's first tiles in flight during the
// decision, and a fit of few chains spreads each chain over a cluster of
// K SMs.  n is capped at what
// one block's shared memory holds at K = 1 (the wrapper sends n > 10368 to
// the obs-tiled kernel, bart_sweep_tiled.cu).
//
// Every kernel is built for three heap sizes: 128 slots (max_depth <=
// 6), 512 (max_depth 7 and 8) and 1024 (max_depth 9), depths the JAX
// package sweeps with XLA only.  The deep builds hold 4x or 8x the
// per-tree state (at 1024 in dynamic shared memory) and two bytes of
// leaf index copy per observation, so one block takes fewer observations
// (n <= 23 424 at 512 and 14 592 at 1024, K = 1, 75 trees;
// ops/bart_sweep_kernel.py:on_chip_ceilings) and fewer blocks fit on an
// SM.  Deeper trees (max_depth 10 and up) run the heap builds
// (sweep_common.cuh: heap_build), launched with a ``heap`` slab: the heap
// size is the run-time pad, the per-tree state lives in the slab (device
// memory, heap_bytes a block) and the tree rows are read from device
// memory, so a block's shared memory holds the observations, the ring and
// a few scalars (n <= 32 384 at K = 1, 75 trees); two instantiations, for
// two-byte leaf copies up to 32 768 slots and four-byte ones past them.
//
// The source is also built for float64 state (S4B_F64: the library
// bart_sweep_batch_f64, symbols ending in _f64), which the JAX package
// sweeps with XLA only: 8 B of residual an observation on chip and 24 B
// of device memory an observation and tree, so one block holds 18 496
// observations at 128 slots (12 032 at 512, 5 856 at 1024, 75 trees).

#include "sweep_cluster.cuh"

namespace {

using namespace s4b;

template <typename Real, int kPad, bool kRegrow>
__global__ void __launch_bounds__(kThreads)
bart_sweep_batch_kernel(SweepArgs<Real> a, int K) {
  extern __shared__ float4 smem4[];
  on_chip_kernel<kRegrow, kPad>(a, K,
                                reinterpret_cast<unsigned char*>(smem4));
}

template <typename Real, int kPad>
int info(int N, int T, int K, int regrow, long long* static_b,
         long long* dynamic_b, int* optin, int* clusters) {
  const size_t dyn =
      on_chip_bytes<kPad, Real>(N, T, K) + state_bytes<kPad, Real>(regrow);
  *dynamic_b = (long long)dyn;
  return regrow
      ? cluster_info(bart_sweep_batch_kernel<Real, kPad, true>, K, dyn,
                     static_b, optin, clusters)
      : cluster_info(bart_sweep_batch_kernel<Real, kPad, false>, K, dyn,
                     static_b, optin, clusters);
}

template <typename Real, int kPad>
int launch(const SweepArgs<Real>& a, int C, int K, void* stream) {
  const size_t dyn = on_chip_bytes<kPad, Real>(a.N, a.T, K)
      + state_bytes<kPad, Real>(with_regrow(a));
  return with_regrow(a)
      ? launch_clusters(bart_sweep_batch_kernel<Real, kPad, true>, a, C, K,
                        dyn, stream)
      : launch_clusters(bart_sweep_batch_kernel<Real, kPad, false>, a, C, K,
                        dyn, stream);
}

}  // namespace

// Writes the kernel's static and dynamic shared memory per block at N, T
// and K (the build's real type, for heaps of ``pad`` slots: with ``heap``
// the heap build, any power of two from 128, else the static build for
// 128, 512 or 1024; with the regrow step when ``regrow``), the device's
// opt-in limit per block, the number of clusters of K blocks that can be
// resident at once and the heap build's slab bytes per block (0 in a
// static build); returns the CUDA error code.
extern "C" int S4B_SYM(bart_sweep_batch_info)(int N, int T, int K, int pad,
                                              int regrow, int heap,
                                              long long* static_b,
                                              long long* dynamic_b,
                                              int* optin, int* clusters,
                                              long long* heap_b) {
  *heap_b = 0;
  if (heap) {
    if (!pad_ok(pad, 0, true)) return (int)cudaErrorInvalidValue;
    *heap_b = (long long)heap_bytes<BuildReal>(pad, regrow);
    return pad <= kPadHeap
        ? info<BuildReal, kPadHeap>(N, T, K, regrow, static_b, dynamic_b,
                                    optin, clusters)
        : info<BuildReal, kPadHeapWide>(N, T, K, regrow, static_b,
                                        dynamic_b, optin, clusters);
  }
  switch (pad) {
    case kPadShallow:
      return info<BuildReal, kPadShallow>(N, T, K, regrow, static_b,
                                          dynamic_b, optin, clusters);
    case kPadDeep:
      return info<BuildReal, kPadDeep>(N, T, K, regrow, static_b, dynamic_b,
                                       optin, clusters);
    case kPadDeepest:
      return info<BuildReal, kPadDeepest>(N, T, K, regrow, static_b,
                                          dynamic_b, optin, clusters);
  }
  return (int)cudaErrorInvalidValue;
}

// Launches one sweep over C chains in clusters of K blocks on ``stream``
// (the operands in the build's real type), the build for heaps of ``pad``
// slots (at least M + 1; zn rows of pad normals): with a ``heap`` slab
// (heap_bytes with the regrow step when it runs, per block: C * K of
// them) the heap build, any power of two from 128, else the static build
// for 128, 512 or 1024; returns the CUDA error code of the launch (0 on
// success).
extern "C" int S4B_SYM(bart_sweep_batch_launch)(SWEEP_HEAD, int K,
                                                void* stream) {
  const SweepArgs<BuildReal> a = SWEEP_ARGS;
  if (!pad_ok(pad, M, heap != nullptr)) return (int)cudaErrorInvalidValue;
  if (heap != nullptr)
    return pad <= kPadHeap ? launch<BuildReal, kPadHeap>(a, C, K, stream)
                           : launch<BuildReal, kPadHeapWide>(a, C, K, stream);
  switch (pad) {
    case kPadShallow: return launch<BuildReal, kPadShallow>(a, C, K, stream);
    case kPadDeep: return launch<BuildReal, kPadDeep>(a, C, K, stream);
    case kPadDeepest: return launch<BuildReal, kPadDeepest>(a, C, K, stream);
  }
  return (int)cudaErrorInvalidValue;
}

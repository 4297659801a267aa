// Per-chain BART Gibbs sweep for Hopper (sm_90a): the sweep of the
// per-chain Gibbs driver (GibbsProgram.step), up to n = 51 840.
//
// Replaces the TPU kernel stan4bart_tpu/ops/bart_sweep_kernel.py:
// _sweep_call (pallas_call at :596, body _make_kernel, per-tree math
// _tree_step_math).  The TPU kernel runs one whole sweep of one chain on
// grid (trees,), vmapped over chains, and carries the running residual in
// VMEM; its lane-sliced body takes it to npad 51 840.  Here each chain is
// one cluster of K thread blocks (grid C * K, where vmap put the chain
// axis), block rank r owning the observations obs_range(N, K, r), and the
// sweep is sweep_on_chip (sweep_cluster.cuh): per tree a grow/prune/change
// Metropolis-Hastings step from six pre-drawn uniforms, conjugate leaf
// values from pre-drawn normals, and the tree's leaf indices, fit and the
// running residual updated.  It computes what ops/bart.py:sweep_trees
// computes, with the arithmetic of bart_sweep_batch.cu and
// bart_sweep_tiled.cu, so the three are bit-identical at equal K.
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
// What bounds it: bytes.  Per (chain, tree) it reads leaf_idx and
// tree_fit and writes both (16 B of device memory per observation); the
// cut-rank row and the weights are shared by every chain and stay in L2.
// On chip, for the whole sweep, are each block's slice of the running
// residual, a byte copy of its leaf indices, the cp.async ring of pass-1
// operands that spans trees, and the exact leaf histograms.  No streaming
// pass is needed: the per-chain limit, npad 51 840, fits a block's shared
// memory at K >= 2 (on_chip_bytes(51 840, 75, 2) is about 171 KB), and
// the launcher refuses a K whose slice does not fit.  The builds for
// 512-slot (max_depth 7 and 8) and 1024-slot heaps (max_depth 9) hold
// fewer observations a block (23 520 and 14 592 with 75 trees), so their
// ceilings are what a cluster of 8 blocks holds (npad 188 160 and
// 116 736; ops/bart_sweep_kernel.py:on_chip_ceilings).  The float64
// build (S4B_F64, bart_sweep_chain_f64) holds half the observations a
// block; its ceilings are capped at the float32 ones (51 840 at 128
// slots, where it runs at K >= 3).  Trees of max_depth 10 and deeper run
// the heap builds (bart_sweep_batch.cu says how), whose ceiling is what
// eight blocks hold (259 840 at 75 trees).

#include "sweep_cluster.cuh"

namespace {

using namespace s4b;

template <typename Real, int kPad, bool kRegrow>
__global__ void __launch_bounds__(kThreads)
bart_sweep_chain_kernel(SweepArgs<Real> a, int K) {
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
      ? cluster_info(bart_sweep_chain_kernel<Real, kPad, true>, K, dyn,
                     static_b, optin, clusters)
      : cluster_info(bart_sweep_chain_kernel<Real, kPad, false>, K, dyn,
                     static_b, optin, clusters);
}

template <typename Real, int kPad>
int launch(const SweepArgs<Real>& a, int C, int K, void* stream) {
  const size_t dyn = on_chip_bytes<kPad, Real>(a.N, a.T, K)
      + state_bytes<kPad, Real>(with_regrow(a));
  return with_regrow(a)
      ? launch_clusters(bart_sweep_chain_kernel<Real, kPad, true>, a, C, K,
                        dyn, stream)
      : launch_clusters(bart_sweep_chain_kernel<Real, kPad, false>, a, C, K,
                        dyn, stream);
}

}  // namespace

// Writes the kernel's static and dynamic shared memory per block at N, T
// and K (the build's real type, for heaps of ``pad`` slots: with ``heap``
// the heap build, any power of two from 128, else the static build for
// 128, 512 or 1024; with the regrow step when ``regrow``), the device's
// opt-in limit per block, the number of clusters of K blocks that can be
// resident at once (0 where a block's slice does not fit) and the heap
// build's slab bytes per block (0 in a static build); returns the CUDA
// error code.
extern "C" int S4B_SYM(bart_sweep_chain_info)(int N, int T, int K, int pad,
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
// success), and an error code without launching for a K outside 1..8 or
// one with no resident cluster (a slice that does not fit in shared
// memory).
extern "C" int S4B_SYM(bart_sweep_chain_launch)(SWEEP_HEAD, int K,
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

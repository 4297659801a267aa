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

#include "sweep_cluster.cuh"

namespace {

using namespace s4b;

template <bool kRegrow>
__global__ void __launch_bounds__(kThreads)
bart_sweep_batch_kernel(SweepArgs a, int K) {
  extern __shared__ float4 smem4[];
  on_chip_kernel<kRegrow>(a, K, reinterpret_cast<unsigned char*>(smem4));
}

}  // namespace

// Writes the kernel's static and dynamic shared memory per block at N, T
// and K (with the regrow step when ``regrow``), the device's opt-in limit
// per block and the number of clusters of K blocks that can be resident
// at once; returns the CUDA error code.
extern "C" int bart_sweep_batch_info(int N, int T, int K, int regrow,
                                     long long* static_b,
                                     long long* dynamic_b, int* optin,
                                     int* clusters) {
  const size_t dyn = on_chip_bytes(N, T, K);
  *dynamic_b = (long long)dyn;
  return regrow ? cluster_info(bart_sweep_batch_kernel<true>, K, dyn,
                               static_b, optin, clusters)
                : cluster_info(bart_sweep_batch_kernel<false>, K, dyn,
                               static_b, optin, clusters);
}

// Launches one sweep over C chains in clusters of K blocks on ``stream``;
// returns the CUDA error code of the launch (0 on success).
extern "C" int bart_sweep_batch_launch(
    const int32_t* feature_in, const int32_t* cut_in, const int32_t* lidx_in,
    const float* tfit_in, const float* resid0, const float* sigma2,
    const float* tau2, const float* u, const float* zn,
    const int32_t* ranks_t, const float* spcum, const float* psplit,
    const float* weights, int32_t* feature_out, int32_t* cut_out,
    float* lv_out, int32_t* lidx_out, float* tfit_out, float* resid_out,
    int C, int T, int N, int P, int M, int max_depth, int n_cuts,
    float p_grow, float p_prune, float trans_grow0, float trans_prune0,
    float p_regrow, const float* rg, int K, void* stream) {
  SweepArgs a{feature_in, cut_in, lidx_in, tfit_in, resid0, sigma2, tau2,
              u, zn, ranks_t, spcum, psplit, weights, feature_out, cut_out,
              lv_out, lidx_out, tfit_out, resid_out, T, N, P, M, max_depth,
              n_cuts, p_grow, p_prune, trans_grow0, trans_prune0};
  a.p_regrow = p_regrow;
  a.rg = rg;
  const size_t dyn = on_chip_bytes(N, T, K);
  return with_regrow(a)
      ? launch_clusters(bart_sweep_batch_kernel<true>, a, C, K, dyn, stream)
      : launch_clusters(bart_sweep_batch_kernel<false>, a, C, K, dyn, stream);
}

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
// the launcher refuses a K whose slice does not fit.

#include "sweep_cluster.cuh"

namespace {

using namespace s4b;

template <bool kRegrow>
__global__ void __launch_bounds__(kThreads)
bart_sweep_chain_kernel(SweepArgs a, int K) {
  extern __shared__ float4 smem4[];
  on_chip_kernel<kRegrow>(a, K, reinterpret_cast<unsigned char*>(smem4));
}

}  // namespace

// Writes the kernel's static and dynamic shared memory per block at N, T
// and K (with the regrow step when ``regrow``), the device's opt-in limit
// per block and the number of clusters of K blocks that can be resident
// at once (0 where a block's slice does not
// fit); returns the CUDA error code.
extern "C" int bart_sweep_chain_info(int N, int T, int K, int regrow,
                                     long long* static_b,
                                     long long* dynamic_b, int* optin,
                                     int* clusters) {
  const size_t dyn = on_chip_bytes(N, T, K);
  *dynamic_b = (long long)dyn;
  return regrow ? cluster_info(bart_sweep_chain_kernel<true>, K, dyn,
                               static_b, optin, clusters)
                : cluster_info(bart_sweep_chain_kernel<false>, K, dyn,
                               static_b, optin, clusters);
}

// Launches one sweep over C chains in clusters of K blocks on ``stream``;
// returns the CUDA error code of the launch (0 on success), and an error
// code without launching for a K outside 1..8 or one with no resident
// cluster (a slice that does not fit in shared memory).
extern "C" int bart_sweep_chain_launch(
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
      ? launch_clusters(bart_sweep_chain_kernel<true>, a, C, K, dyn, stream)
      : launch_clusters(bart_sweep_chain_kernel<false>, a, C, K, dyn, stream);
}

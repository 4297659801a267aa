// Per-chain BART Gibbs sweep for Hopper (sm_90a): the sweep of the
// per-chain Gibbs driver (GibbsProgram.step), up to n = 51 840.
//
// Replaces the TPU kernel stan4bart_tpu/ops/bart_sweep_kernel.py:
// _sweep_call (body _make_kernel, per-tree math _tree_step_math).  The TPU
// kernel runs one whole sweep of one chain on grid (trees,), vmapped over
// chains, and carries the running residual in VMEM; its lane-sliced body
// takes it to npad 51 840.  Here one thread block of kThreads threads per
// chain (grid C, where vmap put the chain axis) loops over all T trees and
// keeps the whole running residual in dynamic shared memory: 51 840 x 4 B =
// 207 360 B, which with the block's ~12 KB of static TreeShared stays under
// the 227 KB a Hopper block may opt in to.  It computes what
// bart_sweep_batch.cu computes (plain version ops/bart.py:sweep_trees),
// with the per-tree arithmetic of sweep_common.cuh and every thread
// walking the observations tid + j * kThreads, so its outputs are
// bit-identical to bart_sweep_batch.cu's and bart_sweep_tiled.cu's where
// those run.
//
// Per tree, three passes over the observations:
//   1. partial residual (R += this tree's old fit) and the six move
//      statistics; the Metropolis-Hastings decision follows;
//   2. new leaf indices, recomputing the go-left bit from the cut-rank
//      row, written to lidx_out, and the per-node leaf statistics; the
//      leaf draw follows;
//   3. the tree's new fit from the leaf indices this thread wrote in pass
//      2 (read back from lidx_out), written to tfit_out and taken off R.
// Unlike bart_sweep_batch.cu there is no byte copy of the leaf indices in
// shared memory: at n = 51 840 residual and copy would need 259 KB.
//
// What bounds it: bytes.  Per (chain, tree) the sweep must read leaf_idx
// and tree_fit and write both (16 B per observation); this design moves
// 28 B: pass 1 reads leaf_idx and tree_fit, pass 2 reads leaf_idx again
// and writes the new one, pass 3 reads that back (from L2, ~207 KB per
// chain) and writes tree_fit.  The cut-rank row and the weights are shared
// by every chain and stay in L2.  Above ~113 KB of shared memory one block
// fits per SM, so past n ~ 28 000 a fit of more than 132 chains runs in
// waves.

#include "sweep_common.cuh"

namespace {

using namespace s4b;

__global__ void __launch_bounds__(kThreads)
bart_sweep_chain_kernel(SweepArgs a) {
  extern __shared__ float4 smem4[];
  float* R = reinterpret_cast<float*>(smem4);               // (N,)
  __shared__ TreeShared s;

  const int N = a.N, T = a.T;
  const int c = blockIdx.x;
  const int tid = threadIdx.x;
  const float s2 = a.sigma2[c], t2 = a.tau2[c];
  const float* __restrict__ wts = a.weights;

  for (int i = tid; i < N; i += kThreads) R[i] = a.resid0[(size_t)c * N + i];

  for (int t = 0; t < T; ++t) {
    const size_t ct = (size_t)c * T + t;
    const Move mv = begin_tree(a, s, ct);
    const int32_t* __restrict__ li_in = a.lidx_in + ct * N;
    const float* __restrict__ tf_in = a.tfit_in + ct * N;
    const int32_t* __restrict__ rank_row = mv.rank_row;

    // pass 1: partial residual and the six move statistics
    float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int i = tid; i < N; i += kThreads) {
      float r = R[i] + tf_in[i];
      R[i] = r;
      float w = wts ? wts[i] : 1.0f;
      float wr = wts ? w * r : r;
      add_move_stats(acc, mv, li_in[i], rank_row[i] <= mv.cn, w, wr);
    }
    const bool accept = decide(a, s, mv, acc, ct, s2, t2);

    // pass 2: new leaf indices and per-node leaf statistics
    int32_t* __restrict__ li_out = a.lidx_out + ct * N;
    for (int base = 0; base < N; base += kThreads) {
      const int i = base + tid;
      const bool in = i < N;
      int li = -1;
      float w = 0.0f, wr = 0.0f;
      if (in) {
        li = moved_leaf(mv, accept, li_in[i], rank_row[i] <= mv.cn);
        li_out[i] = li;
        w = wts ? wts[i] : 1.0f;
        wr = wts ? w * R[i] : R[i];
      }
      hist_add(s, in, li, w, wr);
    }
    __syncthreads();
    draw_leaves(a, s, ct, s2, t2);

    // pass 3: the tree's new fit and the residual without it; each
    // thread reads back only the leaf indices it wrote in pass 2
    float* __restrict__ tf_out = a.tfit_out + ct * N;
    for (int i = tid; i < N; i += kThreads) {
      float nf = s.lv[li_out[i]];
      tf_out[i] = nf;
      R[i] = R[i] - nf;
    }
    __syncthreads();
  }

  for (int i = tid; i < N; i += kThreads)
    a.resid_out[(size_t)c * N + i] = R[i];
}

// Static and dynamic shared memory per block at n observations, and the
// device's opt-in limit per block; returns the CUDA error code.
int smem_bytes(int N, size_t* static_b, size_t* dynamic_b, int* optin) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, bart_sweep_chain_kernel);
  if (err != cudaSuccess) return (int)err;
  int dev = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
  if (err != cudaSuccess) return (int)err;
  *static_b = attr.sharedSizeBytes;
  *dynamic_b = (size_t)N * sizeof(float);
  return 0;
}

}  // namespace

// Writes the kernel's static and dynamic shared-memory bytes per block at
// n = N and the device's opt-in limit per block; returns the CUDA error
// code (0 on success).
extern "C" int bart_sweep_chain_smem(int N, long long* static_b,
                                     long long* dynamic_b, int* optin) {
  size_t st = 0, dy = 0;
  int err = smem_bytes(N, &st, &dy, optin);
  *static_b = (long long)st;
  *dynamic_b = (long long)dy;
  return err;
}

// Launches one sweep over C chains on ``stream``; returns the CUDA error
// code of the launch (0 on success), or cudaErrorInvalidConfiguration
// without launching when the residual does not fit in shared memory.
extern "C" int bart_sweep_chain_launch(
    const int32_t* feature_in, const int32_t* cut_in, const int32_t* lidx_in,
    const float* tfit_in, const float* resid0, const float* sigma2,
    const float* tau2, const float* u, const float* zn,
    const int32_t* ranks_t, const float* spcum, const float* psplit,
    const float* weights, int32_t* feature_out, int32_t* cut_out,
    float* lv_out, int32_t* lidx_out, float* tfit_out, float* resid_out,
    int C, int T, int N, int P, int M, int max_depth, int n_cuts,
    float p_grow, float p_prune, float trans_grow0, float trans_prune0,
    void* stream) {
  SweepArgs a{feature_in, cut_in, lidx_in, tfit_in, resid0, sigma2, tau2,
              u, zn, ranks_t, spcum, psplit, weights, feature_out, cut_out,
              lv_out, lidx_out, tfit_out, resid_out, T, N, P, M, max_depth,
              n_cuts, p_grow, p_prune, trans_grow0, trans_prune0};
  size_t st = 0, dyn = 0;
  int optin = 0;
  int e = smem_bytes(N, &st, &dyn, &optin);
  if (e != 0) return e;
  if (st + dyn > (size_t)optin) return (int)cudaErrorInvalidConfiguration;
  cudaError_t err = cudaFuncSetAttribute(
      bart_sweep_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)dyn);
  if (err != cudaSuccess) return (int)err;
  bart_sweep_chain_kernel<<<C, kThreads, dyn, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

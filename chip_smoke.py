"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --phases 1,2,4  # build + the kernel phases only

Builds the port's five CUDA kernel sources from ``stan4bart_torch/csrc``
with nvcc (one process per source, started together), then:

1. holds every sweep kernel against their plain PyTorch version at small
   sizes (20 trees, 16 chains, 3 chained sweeps, unweighted, weighted and
   a probit-style target), at n = 2000 and at n = 9191, which is not a
   multiple of any tile: the single-pass, obs-tiled and per-chain
   kernels at every cluster size K = 1, 2, 4, 8 (blocks per chain);
   identical forests, leaf values and fits within float32 tolerance; the
   three equal to the bit at every K;
2. does the same at the bench shape (n = 10000, 75 trees, 9 BART
   variables, 256 chains, one sweep from a prior-drawn forest), prints
   each kernel's K and shared memory per block and times the kernels and
   the plain version with CUDA events; then holds the ablation stubs of
   the single-pass kernel (copy, obs) against their plain versions and
   times copy, obs and the full kernel at 256 and at 64 chains; and
   holds the single-pass and per-chain kernels at 128 chains, the shape
   of phases 6-9's fits, at the K they pick there;
3. runs the single-pass kernel's main path: ``stan4bart_torch.stan4bart``
   on the flagship Friedman model at n = 10000 with 256 chains on the card
   (150 iterations, 75 of them warmup), checks that every sweep went
   through that kernel, that the draws are finite and that the fit passes
   the reference's quality gates, and prints the K it used;
4. holds the obs-tiled kernel, at its default K and at K = 1 (residual in
   device memory), against the plain version at the reference's large-n
   shapes (n = 50000 with 64 chains, n = 200000 with 16 chains; 75
   trees, 9 variables) and times them; at n = 50000 and at the per-chain
   kernel's limit, n = 51840 (64 chains), also the per-chain kernel at
   its K, against the plain version and to the bit against the obs-tiled
   one at the same K, with its K and shared memory per block, and at
   n = 50000 its time at every K = 2..8 (K = 1 does not fit on chip);
   and the obs-tiled kernel at n = 50000 with 32 chains, phase 5's shape,
   at the K it picks there;
5. runs the obs-tiled kernel's main path: the same fit at n = 50000 with
   32 chains, every sweep through the obs-tiled kernel, with the same
   checks.  It runs 225 iterations, 150 of them warmup, so the gates
   read the last 75 draws: at n = 50000 the chains' sigma needs about
   150-225 iterations to come down from its start (the 25-iteration
   blocks it prints show it), and at 150 / 75 the posterior-mean sigma
   misses the gate;
6. runs the per-chain path: the phase 3 fit (at 128 chains) with
   ``keep_fits=False`` and a callback returning each draw's sigma and BART
   fit, so every
   iteration is ``GibbsProgram.step`` and every sweep the per-chain
   kernel; no raw draws may be stored, and the quality gates are computed
   from the callback's outputs; then a short per-chain fit on the card
   (n = 2000, 16 chains, 40 iterations) with the options that path
   serves: a callback beside the raw draws, pooled adaptation of stepsize
   and metric, and the chi(df, scale) hyperprior on k, with its forests
   stored (``keep_trees``): the last stored forest is the swept one,
   ``predict`` over them gives the stored BART fit, ``trees()`` and
   ``print_trees``, and a ``save`` / ``load(device="cuda")`` round trip
   whose ``continue_sampling(10)`` (per-chain kernel) is held against the
   original's; then one short fit per non-default ``offset_type`` with a
   user offset, each finite and with the level interweave off;
7. runs the stored-forest surfaces at full width: a probit fit of the
   phase 3 shape (n = 10000, 128 chains, 150 iterations, 75 warmup) with
   ``keep_trees``, every sweep through the single-pass kernel; the
   reference's binary gates; ``predict`` over the stored forests against
   the in-loop test and train fits (1e-5), with its seconds and the peak
   device memory; ``loo`` / ``waic`` of the probit fit over its last 15
   iterations; ``continue_sampling(10)`` whole and in chunks of 4, each
   with 10 launches of the single-pass kernel and equal to the bit;
8. runs the model and sampler options at full width: the phase 3 fit (at
   128 chains) with ``qr``, centered random effects,
   ``prior_covariance=lkj()``, ``sigma_gibbs``, ``leaf_gibbs = 1``,
   ``leaf_block = 25`` and one subtree regrow per sweep, every sweep
   through the single-pass kernel; the reference's gaussian gates, SATE
   within 1 of the truth, every posterior-mean Sigma positive definite, its
   per-phase seconds beside phase 3's and its peak device memory; then
   short fits at n = 2000 with 16 chains (12 iterations, 6 warmup): one
   per coefficient prior (hs, hs_plus, laplace, lasso, product_normal, and
   R2 with ``qr``; max_treedepth 4), finite; a probit fit with ``leaf_gibbs
   = 2``, ``leaf_block = 5`` and two regrows per sweep; a per-chain fit
   (callback, ``keep_trees``, ``sigma_gibbs``, centered random effects,
   ``leaf_block = 5``, one regrow per sweep) whose ``predict`` gives its
   stored fits and whose ``continue_sampling(10)`` whole equals one in
   chunks of 5 to the bit; and a ``qr`` fit saved, loaded on the card and
   resumed, its last stored betas R_inv times the final state's rotated
   ones before and after (un-rotated once);
9. runs the other algorithms at full width, on phase 3's data and seed (128
   chains), every sweep through the single-pass kernel: ``algorithm="vi"``
   (its "biased high" warning), ``"advi"`` meanfield and fullrank, each
   with the reference's VI gates (cor(indiv.bart, mu_bart) >= 0.95, the
   treatment's fixed effect within 1.5 of 5, sigma below 3), its
   milliseconds per VI update beside phase 3's NUTS milliseconds per
   iteration and its peak device memory; ``"vi"`` on phase 7's probit data
   with the binary gates and, when phase 7 ran, the deviance ladder (phase
   7's fit at most the probit IRLS fit's deviance and 1.35 x the VI fit's);
   and, when phase 3 ran, ``adjudicate_parametric_smc`` of its fit at 1024
   particles with the reference's gates; then short VI fits at n = 2000
   with 16 chains: one with a callback (the per-chain kernel only), one
   whole against the first iterations of a longer one in chunks and against
   its own ``save`` / ``load`` + resume (to the bit), and one with
   ``sigma_gibbs``.
10. runs the multi-process paths with their ranks as processes on the
   one card (``parallel.mesh.spawn``), joined by gloo over CUDA tensors
   (NCCL refuses two ranks on one card; the backend is printed): a. the
   observation-sharded sweep kernel ``csrc/bart_sweep_sharded.cu`` over 2
   ranks at n = 50 000 (25 000 each) x 64 chains x 75 trees, one sweep
   from a prior-drawn forest on shared variates, against the plain
   sharded sweep (identical forests in every chain, leaf values within
   ``LV_TOL``) and against the obs-tiled kernel over the whole n
   (identical forests in at least 63 chains), the same at phase b's
   shape (n = 10 000 over 2 ranks x 128 chains) at the K and apply blocks
   the kernel picks there, and at world size 1 against the obs-tiled
   kernel; its stats + apply kernels timed with
   CUDA events (median of 7), the sweep with its all-reduces on the host
   clock, the obs-tiled kernel in the same call, and the bound at the
   local n; b. the phase 3 fit at full width on 4 ranks, 2 chain groups
   of 128 chains x ``obs_shards = 2``: every sweep through the sharded
   kernel (its count iterations x trees per rank, no other sweep
   kernel), the gathered draws identical on every rank, the gaussian
   gates and SATE, per-phase seconds and peak memory per rank; c. at
   n = 2 000 x 16 chains x 20 iterations: a 2-rank chain-sharded fit
   equal to the bit, rank by rank, to single-process fits of the same
   chains with the ranks' seeds, and a 2-rank obs-sharded fit whose first
   forests equal the unsharded fit's in all but at most one chain.
11. runs the in-sweep subtree regrow (``bart_args p_regrow``): a. the
   single-pass, obs-tiled and per-chain kernels with p_regrow = 1 against
   the plain sweep on the same (u, zn, rg) variates at the bench shape,
   at phases 6-9's 10 000 x 128 and at phase 5's 50 000 x 32, there also
   the obs-tiled kernel at K = 1, whose residual stays in device memory,
   unweighted and weighted (identical forests and leaf indices in every
   chain), every kernel with every
   regrow gate shut equal to its p_regrow = 0 sweep to the bit, the
   chains whose forests the move changed, and at the bench shape the
   kernels' times at p_regrow 0, 0.25 and 1 with the plain sweep's and
   the bound; b. in phase 10a's two ranks, the sharded kernel with
   p_regrow = 1 against the plain sharded sweep (every chain), with its
   regrow updates and all-reduces per rank, timed; c. the phase 3 fit at
   128 chains with ``bart_args={"p_regrow": 0.25}``, every sweep through
   the single-pass kernel with the move: the gaussian gates and SATE;
   d. ``utils.profiling.profile_phases`` at the bench shape on phase 3's
   final states (n_iter 3, repeats 1), printing ``format_profile``'s
   lines.

``--phases 3,7,9`` runs the listed phases only (``--phases
1,2,4,10a,11a,11b`` the kernel phases; the kernels line needs those;
``10a`` to ``10c`` and ``11a`` to ``11d`` run one part of phase 10 or
11).  Prints the card
(``nvidia-smi``), a ``{"kernels": [...]}`` line, and as its last line
``{"ok": true, "device": {...}}``.  Any failure raises and exits
non-zero.  Needs no network; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
from dataclasses import replace
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# leaf values and fits of kernel vs plain: the same float32 arithmetic
# with the sums taken in another order (tolerances of the JAX package's
# own kernel-vs-XLA parity test)
LV_TOL = dict(rtol=2e-4, atol=2e-5)
FIT_TOL = dict(rtol=5e-4, atol=5e-4)
# the obs stub's per-node sums of up to 10^4 residuals of magnitude up to
# ~20, summed in another order: float32 rounding of up to ~n eps max|r|
STATS_TOL = dict(rtol=5e-4, atol=1e-2)
# HBM rate of the H100 SXM (NVIDIA data sheet) for the memory bound
HBM_BYTES_PER_S = 3.35e12
P = 9
KERNELS = ("bart_sweep_batch", "bart_sweep_tiled", "bart_sweep_chain",
           "bart_sweep_ablate", "bart_sweep_sharded")
# phase 10's ranks share the card; NCCL refuses two ranks on one card
RANK_BACKEND = "gloo"

FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")


def card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def forest_setup(n, trees, chains, seed, device):
    """Friedman-like data, its cut ranks, and a prior-drawn forest."""
    from stan4bart_torch.ops import bart as ops
    from stan4bart_torch.ops.bart_sweep_kernel import make_sweep_consts

    rng = np.random.default_rng(seed)
    X = rng.uniform(size=(n, P))
    y = (10 * np.sin(np.pi * X[:, 0] * X[:, 1]) + 20 * (X[:, 2] - .5) ** 2
         + 5 * X[:, 4] + rng.normal(size=n))
    cfg = ops.BartConfig(num_trees=trees)
    ranks = ops.compute_ranks(X, ops.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = ops.sample_trees_from_prior(
        cfg, gen, torch.as_tensor(ranks, device=device), sp, chains,
        dtype=torch.float32)
    consts = make_sweep_consts(cfg, ranks, sp, device=device)
    yt = torch.as_tensor(y - y.mean(), dtype=torch.float32, device=device)
    return cfg, state, yt, consts, gen


def compare(name, sk, sp_, vk, vp):
    """Per-chain structural identity and value agreement of two sweeps."""
    same = ((sk.feature == sp_.feature).flatten(1).all(1)
            & (sk.cut == sp_.cut).flatten(1).all(1)
            & (sk.leaf_idx == sp_.leaf_idx).flatten(1).all(1)
            & (vk == vp).all(1))
    ok = same.nonzero()[:, 0]
    err = 0.0
    if len(ok):
        err = max(float((sk.leaf_value[ok] - sp_.leaf_value[ok]).abs().max()),
                  float((sk.allfit[ok] - sp_.allfit[ok]).abs().max()))
        torch.testing.assert_close(sk.leaf_value[ok], sp_.leaf_value[ok],
                                   **LV_TOL, msg=f"{name}: leaf values")
        torch.testing.assert_close(sk.allfit[ok], sp_.allfit[ok], **FIT_TOL,
                                   msg=f"{name}: allfit")
        torch.testing.assert_close(sk.tree_fit[ok], sp_.tree_fit[ok],
                                   **FIT_TOL, msg=f"{name}: tree_fit")
    return int(same.sum()), err


def as_state(state, out, target):
    """The BartState of a sweep's raw outputs (feature, cut, leaf_value,
    leaf_idx, tree_fit, resid)."""
    return state._replace(feature=out[0], cut=out[1], leaf_value=out[2],
                          leaf_idx=out[3], tree_fit=out[4],
                          allfit=target - out[5])


def bit_equal(a, b):
    """Whether two sweeps' states are equal to the bit."""
    return all(torch.equal(getattr(a, f), getattr(b, f))
               for f in ("feature", "cut", "leaf_value", "leaf_idx",
                         "tree_fit", "allfit"))


def phase_small(device, n):
    """The three kernels (through their wrappers) vs plain at every
    cluster size K, 3 chained sweeps per case; to the bit: the three at
    equal K.  Returns the max |kernel - plain| of each kernel."""
    from stan4bart_torch.ops import bart as ops
    from stan4bart_torch.ops.bart_sweep_kernel import (
        CLUSTERS, bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, sweep_plain)

    C = 16
    cfg, state, yt, consts, gen = forest_setup(n, 20, C, 1, device)
    wts = torch.as_tensor(np.random.default_rng(2).uniform(0.5, 2.0, n),
                          dtype=torch.float32, device=device)
    y_probit = ops.sample_probit_latents(
        torch.zeros((C, n), device=device), (yt > 0).float(), gen)
    cases = {"unweighted": (yt.expand(C, n), None),
             "weighted": (yt.expand(C, n), wts),
             "probit": (y_probit, None)}
    err = {"batch": 0.0, "tiled": 0.0, "chain": 0.0}
    for case, (target, w) in cases.items():
        sigma = torch.full((C,), 1.0 if case == "probit" else 0.9,
                           device=device)
        runs = {"plain": state}
        runs.update({(kind, K): state for kind in ("batch", "tiled", "chain")
                     for K in CLUSTERS})
        for sweep in range(3):
            var = ops.draw_variates(gen, C, cfg.num_trees, torch.float32,
                                    device)
            vc = {}
            for key, st in runs.items():
                kw = dict(weights=w, variates=var)
                if key == "plain":
                    # the plain version on the same card and inputs
                    out = sweep_plain(
                        cfg, st.feature, st.cut, st.leaf_idx, st.tree_fit,
                        (target - st.allfit).contiguous(), sigma * sigma,
                        st.sigma_mu * st.sigma_mu, var[0], var[1], consts,
                        weights=w)
                    runs[key] = as_state(st, out, target)
                    vc[key] = ops.count_variable_use(out[0], P)
                else:
                    fn = {"batch": bart_sweep_fused_batch,
                          "tiled": bart_sweep_fused_batch_tiled,
                          "chain": bart_sweep_fused}[key[0]]
                    runs[key], vc[key] = fn(cfg, st, target, consts, sigma,
                                            None, cluster=key[1], **kw)
            tag = f"phase 1 n={n} {case} sweep {sweep}"
            for key in runs:
                if key == "plain":
                    continue
                n_same, e = compare(f"{tag}: {key} vs plain", runs[key],
                                    runs["plain"], vc[key], vc["plain"])
                if n_same != C:
                    raise AssertionError(f"{tag}: {key} vs plain: "
                                         f"{C - n_same} of {C} chains differ")
                err[key[0]] = max(err[key[0]], e)
            pairs = [((kind, K), ("batch", K)) for K in CLUSTERS
                     for kind in ("tiled", "chain")]
            for a, b in pairs:
                if not bit_equal(runs[a], runs[b]):
                    raise AssertionError(f"{tag}: {a} and {b} not equal to "
                                         "the bit")
        print(f"phase 1 n={n} {case}: 3 sweeps, {C}/{C} chains identical "
              f"(batch, tiled and chain at K = {CLUSTERS} vs plain; tiled "
              "and chain equal to batch to the bit at every K), internal "
              f"nodes {int((runs[('tiled', 1)].feature >= 0).sum())}",
              flush=True)
    print(f"phase 1 n={n} ok: max |batch - plain| {err['batch']:.3g}, "
          f"|tiled - plain| {err['tiled']:.3g}, |chain - plain| "
          f"{err['chain']:.3g} (leaf values rtol {LV_TOL['rtol']} atol "
          f"{LV_TOL['atol']}, fits rtol {FIT_TOL['rtol']} atol "
          f"{FIT_TOL['atol']})", flush=True)
    return err["batch"], err["tiled"], err["chain"]


def _time(fn, reps):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times)), times


def copy_bandwidth(device, nbytes=2 ** 30, reps=5):
    """Bytes per second this card moves in a device-to-device copy of
    ``nbytes`` (each byte read once and written once)."""
    src = torch.empty(nbytes // 4, dtype=torch.float32, device=device)
    dst = torch.empty_like(src)
    dst.copy_(src)
    ms, _ = _time(lambda: dst.copy_(src), reps)
    return 2 * nbytes / (ms * 1e-3)


def sweep_bytes(C, T, N, M):
    """Bytes one sweep must move: per (chain, tree) leaf_idx and tree_fit
    read and written (16 B per observation), the ranks table, the
    residual in and out, the tree rows and the variates."""
    return (C * T * N * 16 + P * N * 4 + C * N * 8
            + C * T * (M * 4 * 2 + M * 4 * 3 + 8 * 4 + 128 * 4))


def sweep_args(N, T, C, seed, device):
    """One sweep's kernel operands from a prior-drawn forest."""
    from stan4bart_torch.ops import bart as ops

    cfg, state, yt, consts, gen = forest_setup(N, T, C, seed, device)
    state = state._replace(sigma_mu=torch.full((C,), 0.5 / (2 * np.sqrt(T)),
                                               device=device))
    var = ops.draw_variates(gen, C, T, torch.float32, device)
    args = (cfg, state.feature, state.cut, state.leaf_idx, state.tree_fit,
            (yt - state.allfit).contiguous(), torch.full((C,), 1.0,
                                                         device=device),
            (state.sigma_mu ** 2).contiguous(), var[0].contiguous(),
            var[1].contiguous(), consts)
    return cfg, state, yt, args


def check_sweep(name, outs, state, yt, C, N, T, min_same):
    """Hold each of ``outs`` (label -> raw outputs) against ``plain``."""
    from stan4bart_torch.ops.bart import count_variable_use

    ref = as_state(state, outs["plain"], yt)
    vref = count_variable_use(ref.feature, P)
    res = {}
    for label, out in outs.items():
        if label == "plain":
            continue
        s = as_state(state, out, yt)
        n_same, err = compare(f"{name} {label}", s, ref,
                              count_variable_use(s.feature, P), vref)
        print(f"{name}: {label} {n_same}/{C} chains identical to the plain "
              f"version (n={N}, trees={T}, P={P}); max |kernel - plain| on "
              f"them {err:.3g}", flush=True)
        if n_same < min_same:
            raise AssertionError(f"{name}: {label} only {n_same}/{C} "
                                 "chains identical")
        res[label] = (n_same, err)
    return res


def smem_note(name, N, T, K, regrow=False):
    """One line on kernel ``name``'s shared memory per block at K (of its
    instantiation with the regrow step when ``regrow``)."""
    from stan4bart_torch.ops.bart_sweep_kernel import kernel_smem

    m = kernel_smem(name, N, T, K, regrow)
    where = ("in device memory" if not m["resid_on_chip"]
             else "on chip" if m["clusters"] else "slice does not fit")
    return (f"{name}{' with the regrow' if regrow else ''} K={K}: "
            f"{m['static']} B static + {m['dynamic']} B "
            f"dynamic shared memory per block of the {m['optin']} B opt-in "
            f"limit, {m['clusters']} clusters resident at once, residual "
            f"{where}")


def hold_at_path_shape(device, label, N, C, kernels, seed, T=75):
    """Each kernel of ``kernels`` (its name in ``check_sweep``'s lines ->
    (launcher, wrapper)) at a main path's cut shape, at the K its wrapper
    picks there, against the plain version; the largest error per name."""
    from stan4bart_torch.ops.bart_sweep_kernel import sweep_plain

    _, state, yt, args = sweep_args(N, T, C, seed, device)
    outs, ks = {}, {}
    for name, (launch, wrapper) in kernels.items():
        outs[name] = launch(*args)
        ks[name] = wrapper.last_cluster
    outs["plain"] = sweep_plain(*args)
    torch.cuda.synchronize()
    res = check_sweep(f"{label} n={N} chains={C}", outs, state, yt, C, N, T,
                      C - 1)
    print(f"{label} n={N} chains={C}: the K each kernel picks at a main "
          "path's shape: " + ", ".join(f"{k} K={v}" for k, v in ks.items()),
          flush=True)
    return {k: v[1] for k, v in res.items()}


def phase_full(device, reps=7, C=256, N=10_000, T=75):
    """The three kernels vs plain at the bench shape, and their times."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, kernel_smem, sweep_chain_cuda,
        sweep_cuda, sweep_plain, sweep_tiled_cuda)

    cfg, state, yt, args = sweep_args(N, T, C, 3, device)
    outs = {"batch": sweep_cuda(*args), "tiled": sweep_tiled_cuda(*args),
            "chain": sweep_chain_cuda(*args), "plain": sweep_plain(*args)}
    torch.cuda.synchronize()
    kb = bart_sweep_fused_batch.last_cluster
    kt = bart_sweep_fused_batch_tiled.last_cluster
    kc = bart_sweep_fused.last_cluster
    res = check_sweep("phase 2", outs, state, yt, C, N, T, C - 1)
    for label, k in (("tiled", kt), ("chain", kc)):
        same = all(torch.equal(x, y) for x, y in zip(outs["batch"],
                                                     outs[label]))
        print(f"phase 2: {label} (K={k}) and batch (K={kb}) outputs "
              f"bit-identical: {same}", flush=True)
        if not same:
            raise AssertionError(f"phase 2: {label} differs from batch")
    del outs
    # phases 6-9 run their fits at 128 chains, where the K differs
    at128 = hold_at_path_shape(
        device, "phase 2", N, 128,
        {"batch": (sweep_cuda, bart_sweep_fused_batch),
         "chain": (sweep_chain_cuda, bart_sweep_fused)}, seed=6, T=T)

    scan = []
    for k in range(1, 5):     # at least 2048 observations per block
        m = kernel_smem("bart_sweep_batch", N, T, k)
        ms = _time(lambda: sweep_cuda(*args, cluster=k), 3)[0]
        scan.append(f"K={k} {ms:.4f} ms ({m['clusters']} clusters "
                    "resident)")
    print("phase 2: batch kernel by K, median of 3: " + "; ".join(scan),
          flush=True)
    b_ms, b_all = _time(lambda: sweep_cuda(*args), reps)
    t_ms, t_all = _time(lambda: sweep_tiled_cuda(*args), reps)
    c_ms, c_all = _time(lambda: sweep_chain_cuda(*args), reps)
    p_ms, p_all = _time(lambda: sweep_plain(*args), max(5, reps // 2))
    nbytes = sweep_bytes(C, T, N, cfg.max_nodes)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bw = copy_bandwidth(device)
    print(f"phase 2 {smem_note('bart_sweep_batch', N, T, kb)}; "
          f"{smem_note('bart_sweep_tiled', N, T, kt)}; "
          f"{smem_note('bart_sweep_chain', N, T, kc)}", flush=True)
    print(f"phase 2 times over {reps} reps: batch kernel (K={kb}) median "
          f"{b_ms:.4f} ms {[round(t, 4) for t in b_all]}; tiled kernel "
          f"(K={kt}) median {t_ms:.4f} ms {[round(t, 4) for t in t_all]}; "
          f"chain kernel (K={kc}) median {c_ms:.4f} ms "
          f"{[round(t, 4) for t in c_all]}; plain median {p_ms:.4f} ms; "
          f"memory bound {bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s), {nbytes / bw * 1e3:.4f} ms at "
          f"the measured copy rate {bw / 1e12:.3f} TB/s; {card()}",
          flush=True)
    return dict(ms=b_ms, plain_ms=p_ms, bound_ms=bound_ms,
                max_abs_err=max(res["batch"][1], at128["batch"]), cluster=kb,
                tiled_ms=t_ms, tiled_max_abs_err=res["tiled"][1],
                chain_ms=c_ms,
                chain_max_abs_err=max(res["chain"][1], at128["chain"]),
                chain_cluster=kc)


def phase_ablate(device, C, reps=7, N=10_000, T=75):
    """The ablation stubs of the single-pass kernel against their plain
    versions, and the copy, obs and full times at C chains."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        ablate_cuda, ablate_plain, bart_sweep_ablate, bart_sweep_fused_batch,
        sweep_cuda)

    cfg, state, yt, args = sweep_args(N, T, C, 5, device)
    lv = state.leaf_value.contiguous()
    stub = (args[1], args[2], lv, args[3], args[4], args[5])
    u, consts = args[8], args[10]
    err = 0.0
    for mode in ("copy", "obs"):
        k = ablate_cuda(mode, *stub, u, consts)
        p = ablate_plain(mode, *stub)
        torch.cuda.synchronize()
        for i, (x, y) in enumerate(zip(k, p)):
            if x.dtype == torch.int32:
                if not torch.equal(x, y):
                    raise AssertionError(f"ablate {mode}: output {i} differs")
            else:
                torch.testing.assert_close(
                    x, y, **(STATS_TOL if i == 6 else FIT_TOL),
                    msg=f"ablate {mode}: output {i}")
                err = max(err, float((x - y).abs().max()))
    K = bart_sweep_ablate.last_cluster
    ms = {"copy": _time(lambda: ablate_cuda("copy", *stub, u, consts),
                        reps)[0],
          "obs": _time(lambda: ablate_cuda("obs", *stub, u, consts),
                       reps)[0],
          "full": _time(lambda: sweep_cuda(*args), reps)[0]}
    plain_ms = _time(lambda: ablate_plain("obs", *stub), 3)[0]
    if bart_sweep_fused_batch.last_cluster != K:
        raise AssertionError("ablate: stubs and full kernel differ in K")
    bound_ms = sweep_bytes(C, T, N, cfg.max_nodes) / HBM_BYTES_PER_S * 1e3
    print(f"phase 2 ablation C={C} N={N} T={T} K={K}: stubs equal their "
          f"plain versions (max |stub - plain| {err:.3g}); copy "
          f"{ms['copy']:.4f} ms, obs {ms['obs']:.4f} ms, full "
          f"{ms['full']:.4f} ms: node math (full - obs) "
          f"{ms['full'] - ms['obs']:.4f} ms, observation work (obs - copy) "
          f"{ms['obs'] - ms['copy']:.4f} ms, floor (copy) {ms['copy']:.4f} "
          f"ms; bound {bound_ms:.4f} ms; plain obs {plain_ms:.4f} ms; "
          f"{card()}", flush=True)
    return dict(ms, max_abs_err=err, bound_ms=bound_ms, plain_ms=plain_ms,
                cluster=K)


def phase_large(device, N, C, reps=7, T=75):
    """The obs-tiled kernel at its default K and at K = 1, and the
    per-chain one at its K where it runs, vs plain at a large-n shape, and
    their times; the per-chain kernel to the bit against the obs-tiled one
    at the same K, and at n = 50 000 timed at every K it fits."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        MAX_CLUSTER, MAX_N_CHAIN, bart_sweep_fused,
        bart_sweep_fused_batch_tiled, kernel_smem, sweep_chain_cuda,
        sweep_plain, sweep_tiled_cuda)

    chain = N <= MAX_N_CHAIN
    cfg, state, yt, args = sweep_args(N, T, C, 4, device)
    outs = {"tiled": sweep_tiled_cuda(*args)}
    K = bart_sweep_fused_batch_tiled.last_cluster
    outs["tiled K=1"] = sweep_tiled_cuda(*args, cluster=1)
    outs["plain"] = sweep_plain(*args)
    if chain:
        outs["chain"] = sweep_chain_cuda(*args)
        kc = bart_sweep_fused.last_cluster
        tiled_kc = sweep_tiled_cuda(*args, cluster=kc)
    torch.cuda.synchronize()
    res = check_sweep(f"phase 4 n={N}", outs, state, yt, C, N, T, C - 1)
    out = dict(max_abs_err=max(res["tiled"][1], res["tiled K=1"][1]),
               cluster=K)
    print(f"phase 4 n={N} {smem_note('bart_sweep_tiled', N, T, K)}; "
          f"{smem_note('bart_sweep_tiled', N, T, 1)}", flush=True)
    if chain:
        same = all(torch.equal(x, y) for x, y in zip(tiled_kc,
                                                     outs["chain"]))
        print(f"phase 4 n={N}: chain and tiled (K={kc}) outputs "
              f"bit-identical: {same}; "
              f"{smem_note('bart_sweep_chain', N, T, kc)}; "
              f"{smem_note('bart_sweep_chain', N, T, 1)}", flush=True)
        if not same:
            raise AssertionError(f"phase 4 n={N}: chain differs from tiled")
        if kernel_smem("bart_sweep_chain", N, T, 1)["clusters"] == 0:
            # no fallback: a K whose slice does not fit raises
            try:
                sweep_chain_cuda(*args, cluster=1)
            except RuntimeError as e:
                print(f"phase 4 n={N}: chain kernel at K=1 refused: {e}",
                      flush=True)
            else:
                raise AssertionError(f"phase 4 n={N}: chain kernel ran at "
                                     "K=1, whose slice does not fit")
        out.update(chain_max_abs_err=res["chain"][1], chain_cluster=kc)
        del tiled_kc
    del outs
    out["ms"], k_all = _time(lambda: sweep_tiled_cuda(*args), reps)
    out["k1_ms"], k1_all = _time(lambda: sweep_tiled_cuda(*args, cluster=1),
                                 reps)
    msg = (f"phase 4 n={N} chains={C}: tiled kernel (K={K}) median "
           f"{out['ms']:.4f} ms {[round(t, 4) for t in k_all]}; tiled "
           f"kernel (K=1) median {out['k1_ms']:.4f} ms "
           f"{[round(t, 4) for t in k1_all]}")
    if chain:
        out["chain_ms"], c_all = _time(lambda: sweep_chain_cuda(*args), reps)
        msg += (f"; chain kernel (K={kc}) median {out['chain_ms']:.4f} ms "
                f"{[round(t, 4) for t in c_all]}")
        if kc == K:
            msg += (f", {out['chain_ms'] / out['ms']:.4f}x the tiled "
                    "kernel's")
    # the obs-tiled kernel at every cluster size, for the cluster rule
    scan = []
    for k in range(1, MAX_CLUSTER + 1):
        m = kernel_smem("bart_sweep_tiled", N, T, k)
        ms = _time(lambda: sweep_tiled_cuda(*args, cluster=k), 3)[0]
        scan.append(f"K={k} {ms:.4f} ms ({m['clusters']} clusters resident"
                    f"{', residual on chip' if m['resid_on_chip'] else ''})")
    print(f"phase 4 n={N} chains={C}: tiled kernel by K, median of 3: "
          + "; ".join(scan), flush=True)
    if chain and N == 50_000:
        # the per-chain kernel at every K whose slice fits on chip
        scan = []
        for k in range(1, MAX_CLUSTER + 1):
            m = kernel_smem("bart_sweep_chain", N, T, k)
            if m["clusters"] < 1:
                scan.append(f"K={k} does not fit")
                continue
            ms = _time(lambda: sweep_chain_cuda(*args, cluster=k), 3)[0]
            scan.append(f"K={k} {ms:.4f} ms ({m['clusters']} clusters "
                        "resident)")
        print(f"phase 4 n={N} chains={C}: chain kernel by K, median of 3: "
              + "; ".join(scan), flush=True)
    out["plain_ms"], p_all = _time(lambda: sweep_plain(*args),
                                   max(5, reps // 2))
    nbytes = sweep_bytes(C, T, N, cfg.max_nodes)
    out["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"{msg}; plain median {out['plain_ms']:.4f} ms "
          f"{[round(t, 4) for t in p_all]}; memory bound "
          f"{out['bound_ms']:.4f} ms ({nbytes / 1e9:.4f} GB at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2 ** 30:.2f} GiB; {card()}",
          flush=True)
    torch.cuda.empty_cache()
    return out


def launch_counters():
    """Each kernel's wrapper, whose ``launches`` counts its launches."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_ablate, bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, bart_sweep_fused_sharded)

    return {"bart_sweep_batch": bart_sweep_fused_batch,
            "bart_sweep_tiled": bart_sweep_fused_batch_tiled,
            "bart_sweep_chain": bart_sweep_fused,
            "bart_sweep_ablate": bart_sweep_ablate,
            "bart_sweep_sharded": bart_sweep_fused_sharded}


def reset_counts():
    """Every launch count set to 0 (and every count of launches that ran
    the in-sweep regrow); returns the wrappers by kernel."""
    counts = launch_counters()
    for fn in counts.values():
        fn.launches = 0
        fn.regrow_launches = 0
    return counts


def check_launches(label, counts, kernel, expected):
    """``kernel`` launched ``expected`` times since ``reset_counts``, every
    other kernel not at all."""
    launches = {k: fn.launches for k, fn in counts.items()}
    for k, got in launches.items():
        want = expected if k == kernel else 0
        if got != want:
            raise AssertionError(f"{label}: {k} launched {got} times, "
                                 f"expected {want}")
    return launches[kernel]


def run_fit(label, device, n, chains, kernel, iters, warmup, trees,
            binary=False, data=None, **fit_kw):
    """The flagship fit at full width through the user entry point, with
    the launch counts read just after it: every sweep must launch
    ``kernel`` and no other sweep kernel."""
    import stan4bart_torch
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    d = (data if data is not None else
         generate_friedman_data(n, ranef=True, causal=True, binary=binary))
    df = friedman_dataframe(d)
    counts = reset_counts()
    t0 = time.perf_counter()
    kw = dict(stan_args={"max_treedepth": 6}, bart_args={"n_trees": trees})
    kw.update(fit_kw)
    fit = stan4bart_torch.stan4bart(
        FLAGSHIP, df, treatment="z", chains=chains, iter=iters,
        warmup=warmup, seed=11, verbose=-1, device=device, **kw)
    wall = time.perf_counter() - t0
    launches = check_launches(label, counts, kernel,
                              iters * fit.prog.skip_bart + 1)
    tm = fit.timings
    draws_s = chains * (iters - warmup) / tm["sample"]
    K = getattr(counts[kernel], "last_cluster", None)
    print(f"{label}: stan4bart n={n} chains={chains} trees={trees} "
          f"(sweep kernel {kernel}"
          + ("" if K is None else f", cluster K={K}") + ") "
          f"iter={iters} warmup={warmup}: {wall:.1f} s wall, sampling "
          f"{draws_s:.1f} draws/s; per-phase s: NUTS+linear/level Gibbs "
          f"{tm['nuts_gibbs']:.2f}, sweep {tm['sweep']:.2f}, post "
          f"{tm['post']:.2f}, warmup {tm['warmup']:.2f}, sample "
          f"{tm['sample']:.2f}", flush=True)
    return d, fit, launches


def check_gates(label, cor, sigma, kernel, launches, iters):
    print(f"{label} quality: cor(indiv.bart, mu_bart) {cor:.4f} (>= 0.95), "
          f"sigma {sigma:.4f} (0.8 < sigma < 1.4); {kernel} launches "
          f"{launches} = {iters} iterations + 1 init, other sweep kernels "
          "0", flush=True)
    if cor < 0.95 or not 0.8 < sigma < 1.4:
        raise AssertionError(f"{label} quality gates failed")


def centered_cor(a, b):
    return float(np.corrcoef(a - a.mean(), b - b.mean())[0, 1])


def phase_main(device, label, n, chains, kernel, iters=150, warmup=75,
               trees=75):
    """A main path at full width, through the user entry point: every
    sweep must launch ``kernel`` and no other sweep kernel."""
    d, fit, launches = run_fit(label, device, n, chains, kernel, iters,
                               warmup, trees)
    for name in ("stan", "bart_train", "bart_test", "k"):
        arr = getattr(fit.draws, name)
        if not np.all(np.isfinite(arr)):
            raise AssertionError(f"{label}: non-finite {name} draws")
    cor = centered_cor(fit.fitted("indiv.bart"), d["mu_bart"])
    sigma = float(fit.fitted("sigma"))
    trace = fit.extract("sigma", combine_chains=False, include_warmup=True)
    blocks = " ".join(f"{b.mean():.3f}/{int((b.mean(0) > 1.4).sum())}"
                      for b in np.split(trace, range(25, iters, 25)))
    stan = fit.extract("stan")
    td = float(stan[fit.stan_names.index("treedepth__")].mean())
    print(f"{label}: mean treedepth {td:.2f}; sigma by 25-iteration block, "
          f"warmup included (mean over chains/chains above 1.4): {blocks}",
          flush=True)
    check_gates(label, cor, sigma, kernel, launches, iters)
    return launches, fit


def phase_chain(device, label="phase 6", n=10_000, chains=128, iters=150,
                warmup=75, trees=75):
    """The per-chain path at full width: the phase 3 fit with
    ``keep_fits=False`` and a callback, so every iteration runs
    ``GibbsProgram.step`` and every sweep the per-chain kernel; the gates
    come from the callback's outputs."""
    def callback(draw):
        return {"sigma": draw["aux.1"], "yhat": draw.yhat_train}

    d, fit, launches = run_fit(label, device, n, chains, "bart_sweep_chain",
                               iters, warmup, trees, keep_fits=False,
                               callback=callback)
    if fit.draws is None or hasattr(fit.draws, "stan"):
        raise AssertionError(f"{label}: raw draws were stored")
    try:
        fit.extract("ev")
    except ValueError:
        pass
    else:
        raise AssertionError(f"{label}: extract('ev') did not raise")
    out = fit.extract("callback")          # post-warmup draws
    yhat, sigma = out["yhat"], out["sigma"]
    if yhat.shape != (n, chains * (iters - warmup)) or \
            not np.all(np.isfinite(yhat)) or not np.all(np.isfinite(sigma)):
        raise AssertionError(f"{label}: callback outputs {yhat.shape}, "
                             "or not finite")
    check_gates(label, centered_cor(yhat.mean(-1), d["mu_bart"]),
                float(sigma.mean()), "bart_sweep_chain", launches, iters)
    return launches


def phase_options(device, label="phase 6 options", n=2000, chains=16,
                  iters=40, warmup=20, trees=20):
    """A short per-chain fit on the card with a callback beside the raw
    draws, pooled adaptation of stepsize and metric, k ~ chi(1.25) and
    stored forests: the callback's sigma must equal extract('sigma'), k
    must move, and the chains must share one stepsize and metric after
    warmup; the last stored forest must be the swept one, ``predict``
    over the stored forests must give the stored BART fit (1e-5), and a
    resume of the fit saved and loaded on the card is held against the
    original's.  Returns the per-chain kernel's launches."""
    import os
    import tempfile

    import stan4bart_torch
    from stan4bart_torch.utils.friedman import friedman_dataframe

    def callback(draw):
        return {"sigma": draw["aux.1"]}

    d, fit, launches = run_fit(
        label, device, n, chains, "bart_sweep_chain", iters, warmup, trees,
        callback=callback,
        stan_args={"max_treedepth": 6, "pooled_adaptation": True,
                   "pooled_parts": "both"},
        bart_args={"n_trees": trees, "k": stan4bart_torch.chi(1.25),
                   "keep_trees": True})
    sigma_cb = fit.extract("callback")["sigma"]
    k = fit.extract("k", include_warmup=True)
    nuts = fit.final_states.nuts
    same_eps = bool((nuts.da.log_eps == nuts.da.log_eps[0]).all())
    same_metric = bool((nuts.inv_mass == nuts.inv_mass[:1]).all())
    print(f"{label}: callback sigma equals extract('sigma'): "
          f"{np.array_equal(sigma_cb, fit.extract('sigma'))}; k draws "
          f"{k.min():.4f}-{k.max():.4f}; one stepsize {same_eps} and one "
          f"metric {same_metric} across {chains} chains; {launches} "
          "per-chain launches", flush=True)
    if not (np.array_equal(sigma_cb, fit.extract("sigma"))
            and np.all(np.isfinite(k)) and np.ptp(k) > 0 and same_eps
            and same_metric):
        raise AssertionError(f"{label} failed")

    # the stored forests: the last is the state step swept, and walking
    # them over the training rows gives the stored BART fit
    st = fit.final_states.bart
    last_same = all(
        np.array_equal(getattr(fit.draws, name)[:, -1], t.cpu().numpy())
        for name, t in (("tree_feature", st.feature), ("tree_cut", st.cut),
                        ("tree_leaf_value", st.leaf_value)))
    df = friedman_dataframe(d)
    train_err = float(np.abs(fit.predict(df, type="indiv.bart")
                             - fit.extract("indiv.bart")).max())
    rows = len(fit.trees()["n"])
    fit.print_trees(max_print=2)
    print(f"{label}: last stored forest equals the swept state: "
          f"{last_same}; max |predict(train) - extract('indiv.bart')| "
          f"{train_err:.3g} (<= 1e-5); trees() {rows} rows", flush=True)
    if not (last_same and train_err <= 1e-5 and rows > 0):
        raise AssertionError(f"{label}: stored forests")

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.pkl")
        fit.save(path)
        back = stan4bart_torch.Stan4bartFit.load(path, device=device)
    resumed = {}
    for which, f in (("original", fit), ("loaded", back)):
        counts = reset_counts()
        resumed[which] = f.continue_sampling(10)
        launches += check_launches(f"{label} resume of the {which} fit",
                                   counts, "bart_sweep_chain", 10)
    a, b = resumed["original"], resumed["loaded"]
    diff = max(float(np.abs(getattr(a.draws, name).astype(np.float64)
                            - getattr(b.draws, name)).max())
               for name in ("stan", "bart_train", "tree_leaf_value"))
    same_trees = all(np.array_equal(getattr(a.draws, name),
                                    getattr(b.draws, name))
                     for name in ("tree_feature", "tree_cut"))
    finite = all(np.all(np.isfinite(getattr(x.draws, name)))
                 for x in (a, b) for name in ("stan", "bart_train"))
    print(f"{label}: continue_sampling(10) after save / load on the card: "
          f"{b.iterations} iterations, 10 per-chain launches each; max "
          f"|loaded - original| over stan, bart_train and leaf values "
          f"{diff:.3g}, tree structures equal {same_trees}", flush=True)
    if not (a.iterations == b.iterations == fit.iterations + 10
            and finite):
        raise AssertionError(f"{label}: resume after load")
    return launches


def phase_offset_types(device, n=2000, chains=16, trees=20, iters=12,
                       warmup=6):
    """One short fit per non-default offset_type with a user offset taken
    from the generator's components, each through the single-pass
    kernel: finite draws and the level interweave off.  Returns the
    single-pass kernel's launches."""
    from stan4bart_torch.utils.friedman import generate_friedman_data

    d = generate_friedman_data(n, ranef=True, causal=True)
    fixef = np.where(d["z"] == 1, d["mu_fixef_1"], d["mu_fixef_0"])
    offsets = {"fixef": fixef, "ranef": d["mu_ranef"],
               "bart": d["mu_bart"], "parametric": fixef + d["mu_ranef"]}
    launches = 0
    for ot, off in offsets.items():
        label = f"phase 6 offset_type={ot}"
        _, fit, got = run_fit(label, device, n, chains, "bart_sweep_batch",
                              iters, warmup, trees, data=d, offset=off,
                              offset_type=ot)
        launches += got
        finite = all(np.all(np.isfinite(getattr(fit.draws, name)))
                     for name in ("stan", "bart_train", "bart_test", "k"))
        print(f"{label}: finite draws {finite}; level interweave "
              f"{fit.prog.level_gibbs}, linear refresh "
              f"{fit.prog.linear_gibbs}", flush=True)
        if not finite or fit.prog.level_gibbs:
            raise AssertionError(f"{label} failed")
    return launches


def binary_gates(label, fit, d):
    """The reference's probit gates (tests/test_e2e_binary.py:32-105):
    cor(posterior-mean P(y=1), true p) > 0.75, deviance < 0.8 x null,
    ppd in {0, 1} with mean |ppd - ev| < 0.05, and ev = Phi(indiv.bart +
    indiv.fixef + indiv.ranef).  Returns the posterior-mean P(y = 1)."""
    from scipy.special import ndtr      # the standard normal cdf

    ev_draws = fit.extract("ev")
    ev = ev_draws.mean(-1)
    p_true = ndtr(np.where(d["z"] == 1, d["mu_1"], d["mu_0"]))
    cor = float(np.corrcoef(ev, p_true)[0, 1])
    y = d["y"]
    dev = float(-2 * np.sum(y * np.log(ev) + (1 - y) * np.log1p(-ev)))
    p0 = y.mean()
    dev0 = float(-2 * np.sum(y * np.log(p0) + (1 - y) * np.log1p(-p0)))
    ppd = fit.extract("ppd")
    zero_one = bool(np.all((ppd == 0.0) | (ppd == 1.0)))
    ppd_err = float(np.abs(ppd.mean(-1) - ev).mean())
    del ppd
    latent = ndtr(fit.extract("indiv.bart") + fit.extract("indiv.fixef")
                  + fit.extract("indiv.ranef"))
    latent_err = float(np.abs(ev_draws - latent).max())
    print(f"{label} binary gates over {ev_draws.shape[1]} draws: cor(ev, "
          f"true p) {cor:.4f} (> 0.75); deviance {dev:.1f} vs null "
          f"{dev0:.1f} (< 0.8 x); ppd in {{0, 1}} {zero_one}, mean |ppd - "
          f"ev| {ppd_err:.4f} (< 0.05); max |ev - Phi(bart + fixef + "
          f"ranef)| {latent_err:.3g} (<= 1e-6)", flush=True)
    if not (cor > 0.75 and dev < 0.8 * dev0 and zero_one and ppd_err < 0.05
            and latent_err <= 1e-6):
        raise AssertionError(f"{label}: binary gates failed")
    return ev


def phase_probit(device, label="phase 7", n=10_000, chains=128,
                 iters=150, warmup=75, trees=75):
    """The stored-forest surfaces at full width: a probit fit with
    keep_trees through the single-pass kernel, its gates, predict against
    the in-loop fits, loo / waic, and two resumes.  Returns the
    single-pass kernel's launches and the fit's posterior-mean P(y = 1)
    (phase 9's deviance ladder)."""
    from stan4bart_torch.gibbs import tree_map
    from stan4bart_torch.utils.friedman import friedman_dataframe

    d, fit, launches = run_fit(
        label, device, n, chains, "bart_sweep_batch", iters, warmup, trees,
        binary=True, bart_args={"n_trees": trees, "keep_trees": True})
    for name in ("stan", "bart_train", "bart_test", "k", "tree_leaf_value"):
        if not np.all(np.isfinite(getattr(fit.draws, name))):
            raise AssertionError(f"{label}: non-finite {name} draws")
    if fit.draws.tree_feature.shape != (chains, iters, trees, 127):
        raise AssertionError(f"{label}: stored forests "
                             f"{fit.draws.tree_feature.shape}")
    ev = binary_gates(label, fit, d)

    df = friedman_dataframe(d)
    cf = dict(df)
    cf["z"] = 1 - np.asarray(df["z"])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pred_test = fit.predict(cf, type="indiv.bart")
    pred_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    test_err = float(np.abs(pred_test
                            - fit.extract("indiv.bart", sample="test")).max())
    del pred_test
    train_err = float(np.abs(fit.predict(df, type="indiv.bart")
                             - fit.extract("indiv.bart")).max())
    print(f"{label}: predict over {iters - warmup} x {chains} stored "
          f"forests of {trees} trees on {n} counterfactual rows took "
          f"{pred_s:.2f} s, peak device memory {peak / 2 ** 30:.2f} GiB; max "
          f"|predict - extract('indiv.bart', sample='test')| {test_err:.3g}, "
          f"train {train_err:.3g} (each <= 1e-5); {card()}", flush=True)
    if not (test_err <= 1e-5 and train_err <= 1e-5):
        raise AssertionError(f"{label}: predict differs from the stored fits")

    # loo / waic over the last 15 iterations: the Pareto fits and the
    # log-likelihood run on the host, 75 s of the script for all 75
    # post-warmup iterations of 256 chains
    last = replace(fit, draws=tree_map(lambda a: a[:, -15:], fit.draws),
                   warmup=0)
    ic = {}
    for name, f in (("probit loo", last.loo), ("probit waic", last.waic)):
        t0 = time.perf_counter()
        ic[name] = f()
        ic[name]["seconds"] = time.perf_counter() - t0
    msg = []
    for name, r in ic.items():
        keys = (("elpd_loo", "p_loo", "looic") if "loo" in name
                else ("elpd_waic", "p_waic", "waic"))
        if not all(np.isfinite(r[k]) for k in keys):
            raise AssertionError(f"{label}: {name} not finite")
        msg.append(f"{name} " + ", ".join(f"{k} {r[k]:.2f}" for k in keys)
                   + (f", {r['n_high_k']} of {r['n_obs']} pareto_k > 0.7"
                      if "loo" in name else "")
                   + f", {r['seconds']:.2f} s")
    print(f"{label}: " + "; ".join(msg) + f" (over the last 15 iterations, "
          f"{15 * chains} draws)", flush=True)

    resumed = {}
    for which, kw in (("whole", {}), ("chunked", {"chunk_size": 4})):
        counts = reset_counts()
        t0 = time.perf_counter()
        resumed[which] = fit.continue_sampling(10, **kw)
        secs = time.perf_counter() - t0
        launches += check_launches(f"{label} continue_sampling(10) {which}",
                                   counts, "bart_sweep_batch", 10)
        r = resumed[which]
        grew = all(getattr(r.draws, name).shape[1] == iters + 10
                   for name in ("tree_feature", "tree_cut",
                                "tree_leaf_value", "stan"))
        finite = all(np.all(np.isfinite(getattr(r.draws, name)))
                     for name in ("stan", "bart_train", "bart_test",
                                  "tree_leaf_value"))
        print(f"{label}: continue_sampling(10{', chunk_size=4' if kw else ''}"
              f") took {secs:.2f} s, 10 single-pass launches; "
              f"{r.iterations - r.warmup} post-warmup iterations, forests "
              f"grew by 10 {grew}, finite {finite}", flush=True)
        if not (r.iterations - r.warmup == iters - warmup + 10 and grew
                and finite):
            raise AssertionError(f"{label}: resume {which}")
    diff, same = resume_equal(
        resumed["whole"], resumed["chunked"],
        ("stan", "bart_train", "bart_test", "tree_feature", "tree_cut",
         "tree_leaf_value"))
    print(f"{label}: whole vs chunked resume: max difference over stan "
          f"draws, fits and forests {diff:.3g}, equal to the bit {same}",
          flush=True)
    if not same:
        raise AssertionError(f"{label}: whole and chunked resumes differ")
    return launches, ev


def finite_draws(label, fit, names=("stan", "bart_train", "bart_test", "k")):
    for name in names:
        if not np.all(np.isfinite(getattr(fit.draws, name))):
            raise AssertionError(f"{label}: non-finite {name} draws")


def option_flags(fit):
    """The model and sampler options as the fit resolved them."""
    prog, cfg = fit.prog, fit.pm.cfg
    return (f"qr {fit.R_inv is not None}, centered_ranef {cfg.centered}, "
            f"prior_covariance {('decov', 'lkj')[cfg.cov_prior]}, "
            f"prior_dist {cfg.prior_dist}, sigma_gibbs {prog.sigma_gibbs}, "
            f"leaf_gibbs {prog.leaf_gibbs}, leaf_block {prog.leaf_block} "
            f"(dim {prog.leaf_block_dim}), regrow_per_sweep "
            f"{prog.bart_cfg.regrow_per_sweep}; linear_gibbs "
            f"{prog.linear_gibbs}, level_gibbs {prog.level_gibbs}")


def all_options_stan_args(**extra):
    import stan4bart_torch

    return {"max_treedepth": 6, "qr": True, "centered_ranef": True,
            "prior_covariance": stan4bart_torch.lkj(), "sigma_gibbs": True,
            **extra}


def option_costs(fit, reps=3):
    """Milliseconds of one call of each optional update of ``fit``'s
    program on its final state (median of ``reps``): what each adds to an
    iteration (sigma_gibbs to nuts_gibbs, the regrows to sweep, the leaf
    draws to post)."""
    prog, st = fit.prog, fit.final_states
    gen = torch.Generator(device=prog.device)
    gen.manual_seed(0)
    c, _ = prog.pm.layout.constrain(st.nuts.q)
    sigma = prog.pm.transformed(c)["aux"]
    calls = {
        "sigma_gibbs": lambda: prog._sigma_gibbs_update(
            st.nuts.q, st.stan_offset, prog.y, gen),
        "regrow (1 per sweep)": lambda: prog._regrow(
            st.bart, prog.y - st.bart_offset, sigma, gen),
        "leaf_gibbs": lambda: prog._leaf_gibbs_update(
            st.bart, st.bart_offset, st.latents, sigma, gen),
        "leaf_block": lambda: prog._leaf_block_update(
            st.bart, st.bart_offset, st.latents, sigma, gen),
    }
    out = {}
    for name, fn in calls.items():
        times = []
        for _ in range(reps + 1):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
        out[name] = float(np.median(times[1:]))
    return out


def phase_all_options(device, t3, label="phase 8", n=10_000, chains=128,
                iters=150, warmup=75, trees=75):
    """Every option at full width: the phase 3 data and seed with
    every model and sampler option of the single-device fit on (qr,
    centered ranef, lkj, sigma_gibbs, leaf_gibbs, leaf_block, subtree
    regrows), every sweep through the single-pass kernel; the
    reference's gaussian gates, SATE within 1 of the truth, Sigma
    positive definite, and the per-phase seconds beside phase 3's
    (``t3``, its timings, when phase 3 ran).  Returns the single-pass
    kernel's launches."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    d, fit, launches = run_fit(
        label, device, n, chains, "bart_sweep_batch", iters, warmup, trees,
        stan_args=all_options_stan_args(leaf_gibbs=1, leaf_block=25),
        bart_args={"n_trees": trees, "regrow_per_sweep": 1})
    peak = torch.cuda.max_memory_allocated()
    print(f"{label}: options: {option_flags(fit)}; peak device memory "
          f"{peak / 2 ** 30:.2f} GiB; {card()}", flush=True)
    if not (fit.prog.linear_gibbs and fit.prog.level_gibbs
            and fit.prog.sigma_gibbs and fit.R_inv is not None):
        raise AssertionError(f"{label}: an option is off")
    finite_draws(label, fit)
    tm = fit.timings
    if t3 is not None:
        print(f"{label}: per-phase s with the options (phase 3 without, same "
              "call): " + ", ".join(
                  f"{k} {tm[k]:.2f} ({t3[k]:.2f})"
                  for k in ("nuts_gibbs", "sweep", "post", "total")),
              flush=True)
    stan = fit.extract("stan")
    td = float(stan[fit.stan_names.index("treedepth__")].mean())
    nlf = float(stan[fit.stan_names.index("n_leapfrog__")].mean())
    del stan
    print(f"{label}: mean treedepth {td:.2f}, mean leapfrogs {nlf:.1f}; "
          "one call of each option's update on the final state, median of "
          "3 (host clock, synchronized): " + ", ".join(
              f"{k} {v:.2f} ms" for k, v in option_costs(fit).items()),
          flush=True)
    cor = centered_cor(fit.fitted("indiv.bart"), d["mu_bart"])
    sigma = float(fit.fitted("sigma"))
    z = d["z"]
    sate = float(np.mean((fit.fitted("ev") - fit.fitted("ev", sample="test"))
                         * (2 * z - 1)))
    eig = {k: float(np.linalg.eigvalsh(S.mean(-1)).min())
           for k, S in fit.extract("Sigma").items()}
    print(f"{label}: SATE {sate:.4f} (truth {d['tau']}, within 1); smallest "
          "eigenvalue of the posterior-mean Sigma by term: " + ", ".join(
              f"{k} {v:.4g}" for k, v in eig.items()), flush=True)
    check_gates(label, cor, sigma, "bart_sweep_batch", launches, iters)
    if abs(sate - d["tau"]) >= 1.0 or min(eig.values()) <= 0:
        raise AssertionError(f"{label}: SATE or Sigma gate failed")
    return launches


def resume_equal(a, b, names):
    """The largest difference between two fits' draws over ``names``, and
    whether they are equal to the bit."""
    diff = max(float(np.abs(getattr(a.draws, k).astype(np.float64)
                            - getattr(b.draws, k)).max()) for k in names)
    return diff, all(np.array_equal(getattr(a.draws, k), getattr(b.draws, k))
                     for k in names)


def beta_unrotated(fit):
    """The final state's rotated coefficients in the original coordinates,
    R_inv beta_qr, per chain."""
    c, _ = fit.pm.layout.constrain(fit.final_states.nuts.q)
    beta = fit.pm.transformed(c)["beta"].double().cpu().numpy()
    return beta @ fit.R_inv.T


def phase_option_fits(device, label="phase 8 options", n=2000, chains=16,
                        trees=20, iters=12, warmup=6):
    """Short fits of the options at the offset-type size: one per
    coefficient prior (R2 with qr), a probit fit with the leaf draws and
    regrows, a per-chain fit with a callback, stored forests and every
    option the per-chain kernel serves (predict equal to the stored fits,
    a resume whole equal to one in chunks to the bit), and a qr fit
    saved, loaded on the card and resumed (its stored betas un-rotated
    once).  Returns the launches by kernel."""
    import os
    import tempfile

    import stan4bart_torch as s4b
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    launches = {"bart_sweep_batch": 0, "bart_sweep_chain": 0}
    d = generate_friedman_data(n, ranef=True, causal=True)
    priors = (("hs", {"prior": s4b.hs()}),
              ("hs_plus", {"prior": s4b.hs_plus()}),
              ("laplace", {"prior": s4b.laplace()}),
              ("lasso", {"prior": s4b.lasso()}),
              ("product_normal", {"prior": s4b.product_normal()}),
              ("R2", {"prior": s4b.R2(0.5, "mean"), "qr": True}))
    for name, sa in priors:
        # these fits are held to finite draws only, so their trajectories
        # are cut to 2^4 leapfrogs to keep the script's time
        sub = f"{label} prior={name}"
        _, fit, got = run_fit(sub, device, n, chains, "bart_sweep_batch",
                              iters, warmup, trees, data=d,
                              stan_args={"max_treedepth": 4, **sa})
        launches["bart_sweep_batch"] += got
        finite_draws(sub, fit)
        fixef = np.round(fit.fitted("fixef").astype(float), 3).tolist()
        print(f"{sub}: finite draws; posterior-mean fixef {fixef}, sigma "
              f"{float(fit.fitted('sigma')):.4f}; {option_flags(fit)}",
              flush=True)

    sub = f"{label} probit"
    db = generate_friedman_data(n, ranef=True, causal=True, binary=True)
    _, fit, got = run_fit(
        sub, device, n, chains, "bart_sweep_batch", iters, warmup, trees,
        data=db, stan_args={"max_treedepth": 6, "leaf_gibbs": 2,
                            "leaf_block": 5},
        bart_args={"n_trees": trees, "regrow_per_sweep": 2})
    launches["bart_sweep_batch"] += got
    finite_draws(sub, fit)
    print(f"{sub}: finite draws; {option_flags(fit)}", flush=True)
    if fit.prog.sigma_gibbs or fit.prog.leaf_gibbs != 2:
        raise AssertionError(f"{sub}: options")

    sub = f"{label} per-chain"
    _, fit, got = run_fit(
        sub, device, n, chains, "bart_sweep_chain", iters, warmup, trees,
        data=d, callback=lambda draw: {"sigma": draw["aux.1"]},
        stan_args={"max_treedepth": 6, "sigma_gibbs": True,
                   "centered_ranef": True, "leaf_block": 5},
        bart_args={"n_trees": trees, "keep_trees": True,
                   "regrow_per_sweep": 1})
    launches["bart_sweep_chain"] += got
    finite_draws(sub, fit, ("stan", "bart_train", "bart_test",
                            "tree_leaf_value"))
    df = friedman_dataframe(d)
    train_err = float(np.abs(fit.predict(df, type="indiv.bart")
                             - fit.extract("indiv.bart")).max())
    resumed = {}
    for which, kw in (("whole", {}), ("chunked", {"chunk_size": 5})):
        counts = reset_counts()
        resumed[which] = fit.continue_sampling(10, **kw)
        launches["bart_sweep_chain"] += check_launches(
            f"{sub} resume {which}", counts, "bart_sweep_chain", 10)
    names = ("stan", "bart_train", "bart_test", "tree_feature", "tree_cut",
             "tree_leaf_value")
    diff, same = resume_equal(resumed["whole"], resumed["chunked"], names)
    print(f"{sub}: {option_flags(fit)}; max |predict(train) - "
          f"extract('indiv.bart')| {train_err:.3g} (<= 1e-5); "
          f"continue_sampling(10) whole vs chunk_size=5: max difference "
          f"over stan draws, fits and forests {diff:.3g}, equal to the bit "
          f"{same}", flush=True)
    if not (train_err <= 1e-5 and same and fit.prog.sigma_gibbs
            and fit.pm.cfg.centered):
        raise AssertionError(f"{sub} failed")

    sub = f"{label} qr resume"
    _, fit, got = run_fit(sub, device, n, chains, "bart_sweep_batch", iters,
                          warmup, trees, data=d,
                          stan_args={"max_treedepth": 6, "qr": True})
    launches["bart_sweep_batch"] += got
    bi = [fit._name_idx[f"beta.{j + 1}"] for j in range(fit.mf.K)]

    def last_row_err(f):
        return float(np.abs(f.draws.stan[:, -1, bi]
                            - beta_unrotated(f)).max())

    errs = {"fit": last_row_err(fit)}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.pkl")
        fit.save(path)
        back = s4b.Stan4bartFit.load(path, device=device)
    more = {}
    for which, f in (("original", fit), ("loaded", back)):
        counts = reset_counts()
        more[which] = f.continue_sampling(10)
        launches["bart_sweep_batch"] += check_launches(
            f"{sub} resume of the {which} fit", counts, "bart_sweep_batch",
            10)
        errs[which] = last_row_err(more[which])
    kept = all(np.array_equal(m.draws.stan[:, :iters], fit.draws.stan)
               for m in more.values())
    diff, same = resume_equal(more["original"], more["loaded"],
                              ("stan", "bart_train"))
    scale = float(np.abs(fit.draws.stan[..., bi]).max())
    print(f"{sub}: max |last stored beta - R_inv beta_qr(final state)| "
          + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
          + f" (|beta| up to {scale:.3g}); stored draws kept by the resumes "
          f"{kept}; loaded vs original resume equal to the bit {same} "
          f"(max difference {diff:.3g})", flush=True)
    if not (kept and same and all(e <= 1e-6 * max(scale, 1.0)
                                  for e in errs.values())
            and more["loaded"].qr_unrotated):
        raise AssertionError(f"{sub} failed")
    return launches


def vi_update_ms(fit, reps=3):
    """Milliseconds of one VI update of every chain on ``fit``'s final
    state (host clock, synchronized; median of ``reps`` after one
    warm-up call)."""
    prog, st = fit.prog, fit.final_states
    y_stan = st.latents if prog.is_binary else prog.y
    gen = torch.Generator(device=prog.device)
    gen.manual_seed(0)
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        prog._vi_update(st, y_stan, gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times[1:]))


def deviance(p, y):
    """The binomial deviance of probabilities p (clipped to [1e-9,
    1 - 1e-9], as the reference's ladder test does)."""
    p = np.clip(p, 1e-9, 1 - 1e-9)
    return float(-2 * np.sum(y * np.log(p) + (1 - y) * np.log1p(-p)))


def vi_fit(label, device, t3, n, chains, iters, warmup, trees, binary=False,
           **fit_kw):
    """One VI-within-Gibbs fit at full width through the single-pass
    kernel, with its per-phase seconds beside phase 3's NUTS fit (``t3``)
    and its peak device memory; returns (data, fit, launches, the
    warnings it raised)."""
    import warnings

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        d, fit, launches = run_fit(label, device, n, chains,
                                   "bart_sweep_batch", iters, warmup, trees,
                                   binary=binary, **fit_kw)
    peak = torch.cuda.max_memory_allocated()
    finite_draws(label, fit)
    tm, prog = fit.timings, fit.prog
    ms = vi_update_ms(fit)
    nuts_ms = ("" if t3 is None else
               f"; phase 3's NUTS + linear/level Gibbs "
               f"{t3['nuts_gibbs'] / t3['iters'] * 1e3:.2f} ms per "
               "iteration")
    print(f"{label}: {prog.vi_method} {prog.vi_family} q, {prog.vi_steps} "
          f"steps x {prog.vi_mc} draws per iteration: one VI update of "
          f"{chains} chains {ms:.2f} ms (median of 3, host clock, "
          f"synchronized); VI + linear/level Gibbs "
          f"{tm['nuts_gibbs'] / iters * 1e3:.2f} ms per iteration{nuts_ms}; "
          f"peak device memory {peak / 2 ** 30:.2f} GiB; {card()}",
          flush=True)
    if t3 is not None:
        print(f"{label}: per-phase s over {iters} iterations (phase 3's "
              f"NUTS fit over {t3['iters']}, same call): " + ", ".join(
                  f"{k} {tm[k]:.2f} ({t3[k]:.2f})"
                  for k in ("nuts_gibbs", "sweep", "post", "total")),
              flush=True)
    return d, fit, launches, [str(w.message) for w in caught]


def vi_gates(label, fit, d, sigma_lo, sate=False):
    """The reference's VI / ADVI gates (tests/test_vi_gibbs.py:20-28,
    tests/test_algorithms.py:38-50): cor(indiv.bart, mu_bart) >= 0.95
    (the port's phase 3 gate; the reference's small fixture asks 0.9),
    |fixef of z - 5| < 1.5 and sigma_lo < sigma < 3.0; with ``sate``
    the SATE printed too."""
    cor = centered_cor(fit.fitted("indiv.bart"), d["mu_bart"])
    fx = fit.extract("fixef").mean(-1)
    sigma = float(fit.fitted("sigma"))
    msg = ""
    if sate:
        z = d["z"]
        msg = "; SATE {:.4f} (truth {})".format(float(np.mean(
            (fit.fitted("ev") - fit.fitted("ev", sample="test"))
            * (2 * z - 1))), d["tau"])
    print(f"{label} gates: cor(indiv.bart, mu_bart) {cor:.4f} (>= 0.95); "
          f"fixef of z {fx[1]:.4f} (within 1.5 of 5); sigma {sigma:.4f} "
          f"({sigma_lo} < sigma < 3.0){msg}", flush=True)
    if not (cor >= 0.95 and abs(fx[1] - 5.0) < 1.5
            and sigma_lo < sigma < 3.0):
        raise AssertionError(f"{label}: gates failed")


def phase_algorithms(device, t3, fit3, ev7, label="phase 9", n=10_000,
                     chains=128, iters=100, warmup=50, trees=75):
    """The other algorithms at full width, on phase 3's data and seed,
    every sweep through the single-pass kernel: a. algorithm="vi"
    (warns that sigma is biased high), b. "advi" meanfield, c. "advi"
    fullrank, each with the reference's VI gates; d. "vi" on phase 7's
    probit data with the binary gates and, when phase 7 ran (``ev7``),
    the two rungs of the reference's deviance ladder that need no other
    fit; e. SMC adjudication of phase 3's fit (``fit3``) with the
    reference's gates.  100 iterations, 50 of them warmup (150 / 75 met
    the same gates but took 183 s on an H100).
    Returns the single-pass kernel's launches."""
    from stan4bart_torch.fit import _init_parametric_fit
    from scipy.special import ndtr      # the standard normal cdf

    launches = 0
    for sub, algorithm, sa, sigma_lo in (
            ("a vi", "vi", {}, 0.8),
            ("b advi meanfield", "advi", {}, 0.5),
            ("c advi fullrank", "advi", {"vi_family": "fullrank"}, 0.5)):
        sub = f"{label}{sub}"
        d, fit, got, caught = vi_fit(
            sub, device, t3, n, chains, iters, warmup, trees,
            algorithm=algorithm, stan_args={"max_treedepth": 6, **sa})
        launches += got
        warned = any("biased high" in m for m in caught)
        print(f"{sub}: 'biased high' warning {warned}", flush=True)
        if warned != (algorithm == "vi") or fit.prog.vi_family != (
                sa.get("vi_family", "meanfield")):
            raise AssertionError(f"{sub}: warning or family")
        vi_gates(sub, fit, d, sigma_lo, sate=algorithm == "vi")
        del fit

    sub = f"{label}d vi probit"
    d, fit, got, _ = vi_fit(sub, device, t3, n, chains, iters, warmup, trees,
                            binary=True, algorithm="vi")
    launches += got
    ev = binary_gates(sub, fit, d)
    if ev7 is not None:
        y = d["y"]
        eta_glm, _ = _init_parametric_fit(fit.mf, "binomial")
        dev7, dev_glm = deviance(ev7, y), deviance(ndtr(eta_glm), y)
        dev_vi = deviance(ev, y)
        print(f"{sub}: deviance ladder (tests/test_e2e_binary.py:54-93): "
              f"phase 7's NUTS fit {dev7:.1f} <= probit IRLS {dev_glm:.1f}, "
              f"and <= 1.35 x this VI fit's {dev_vi:.1f} "
              f"({1.35 * dev_vi:.1f})", flush=True)
        if not (dev7 <= dev_glm and dev7 <= 1.35 * dev_vi):
            raise AssertionError(f"{sub}: deviance ladder")
    del fit

    if fit3 is not None:
        sub = f"{label}e smc"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        adj = fit3.adjudicate_parametric_smc(n_particles=1024, n_mcmc=8)
        secs = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        names = adj["names"]
        ib, isg = names.index("beta.1"), names.index("aux.1")
        sm, mm = adj["smc_mean"], adj["mcmc_mean"]
        print(f"{sub}: adjudicate_parametric_smc(1024 particles, 8 HMC "
              f"steps) of phase 3's fit took {secs:.2f} s, peak device "
              f"memory {peak / 2 ** 30:.2f} GiB; {card()}; final_temp "
              f"{adj['final_temp']} (1.0), log_evidence "
              f"{adj['log_evidence']:.2f} (finite); beta.1 SMC "
              f"{sm[ib]:.4f} vs MCMC {mm[ib]:.4f} (within 1.0); sigma SMC "
              f"{sm[isg]:.4f} vs MCMC {mm[isg]:.4f} (SMC < MCMC + 0.05, "
              f"> 0.4 x MCMC)", flush=True)
        if not (adj["final_temp"] == 1.0
                and np.isfinite(adj["log_evidence"])
                and abs(sm[ib] - mm[ib]) < 1.0
                and 0.4 * mm[isg] < sm[isg] < mm[isg] + 0.05
                and np.all(np.isfinite(adj["draws"]))):
            raise AssertionError(f"{sub}: gates failed")
    return launches


def phase_algorithm_options(device, label="phase 9 options", n=2000,
                            chains=16, trees=20, iters=20, warmup=10):
    """Short VI fits at the options size: one with a callback (the
    per-chain kernel only), a longer one in chunks whose first iterations
    equal the whole fit's and whose whole run equals that fit saved,
    loaded on the card and resumed, to the bit; and VI with sigma_gibbs.
    Returns the launches by kernel."""
    import os
    import tempfile

    import stan4bart_torch as s4b
    from stan4bart_torch.utils.friedman import generate_friedman_data

    launches = {"bart_sweep_batch": 0, "bart_sweep_chain": 0}
    d = generate_friedman_data(n, ranef=True, causal=True)
    vi = dict(algorithm="vi", stan_args={"max_treedepth": 6})

    sub = f"{label} callback"
    _, fit, got = run_fit(sub, device, n, chains, "bart_sweep_chain", iters,
                          warmup, trees, data=d,
                          callback=lambda draw: {"sigma": draw["aux.1"]},
                          **vi)
    launches["bart_sweep_chain"] += got
    same = np.array_equal(fit.extract("callback")["sigma"],
                          fit.extract("sigma"))
    finite_draws(sub, fit)
    print(f"{sub}: {got} per-chain launches; callback sigma equals "
          f"extract('sigma') {same}", flush=True)
    if not same:
        raise AssertionError(f"{sub} failed")

    sub = f"{label} resume"
    _, whole, got = run_fit(sub, device, n, chains, "bart_sweep_batch",
                            iters, warmup, trees, data=d, **vi)
    launches["bart_sweep_batch"] += got
    _, longer, got = run_fit(f"{sub} uninterrupted, chunk_size=5", device,
                             n, chains, "bart_sweep_batch", iters + 10,
                             warmup, trees, data=d, chunk_size=5, **vi)
    launches["bart_sweep_batch"] += got
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fit.pkl")
        whole.save(path)
        back = s4b.Stan4bartFit.load(path, device=device)
    counts = reset_counts()
    resumed = back.continue_sampling(10)
    launches["bart_sweep_batch"] += check_launches(
        f"{sub} continue_sampling(10)", counts, "bart_sweep_batch", 10)
    names = ("stan", "bart_train", "bart_test", "k")
    head = max(float(np.abs(getattr(whole.draws, k).astype(np.float64)
                            - getattr(longer.draws, k)[:, :iters]).max())
               for k in names)
    diff, same = resume_equal(resumed, longer, names)
    same_vi = all(torch.equal(a, b) for a, b in zip(
        resumed.final_states.vi, longer.final_states.vi))
    print(f"{sub}: whole {iters} iterations vs the first {iters} of "
          f"{iters + 10} in chunks of 5: max difference {head:.3g}; "
          f"save / load on the card + continue_sampling(10) vs "
          f"uninterrupted: max difference {diff:.3g}, equal to the bit "
          f"{same}, final VI state equal {same_vi} (count "
          f"{float(longer.final_states.vi.count[0]):.0f})", flush=True)
    if head or not (same and same_vi):
        raise AssertionError(f"{sub} failed")

    sub = f"{label} sigma_gibbs"
    _, fit, got = run_fit(sub, device, n, chains, "bart_sweep_batch", iters,
                          warmup, trees, data=d, algorithm="vi",
                          stan_args={"max_treedepth": 6,
                                     "sigma_gibbs": True})
    launches["bart_sweep_batch"] += got
    finite_draws(sub, fit)
    print(f"{sub}: sigma_gibbs {fit.prog.sigma_gibbs}; posterior-mean "
          f"sigma {float(fit.fitted('sigma')):.4f}; finite draws",
          flush=True)
    if not fit.prog.sigma_gibbs:
        raise AssertionError(f"{sub}: sigma_gibbs off")
    return launches


def _local_args(args, rank, world):
    """Rank ``rank``'s shard of one sweep's kernel operands (``sweep_args``)
    out of ``world`` equal shards of the observations."""
    from stan4bart_torch.ops.bart_sweep_kernel import SweepConsts

    cfg, feature, cut, lidx, tfit, resid0, s2, t2, u, zn, consts = args
    n = consts.n_obs // world
    sl = slice(rank * n, (rank + 1) * n)
    local = consts._replace(ranks_t=consts.ranks_t[:, sl].contiguous(),
                            n_obs=n, npad=-(-max(n, 128) // 128) * 128)
    assert isinstance(local, SweepConsts)
    return (cfg, feature, cut, lidx[..., sl].contiguous(),
            tfit[..., sl].contiguous(), resid0[:, sl].contiguous(), s2, t2,
            u, zn, local), sl


def _same_chains(a, b, sl_a=slice(None), sl_b=slice(None)):
    """Per chain, whether two sweeps' raw outputs give the same forest and
    leaf indices (over the given observation slices); and the largest
    leaf-value and fit differences over those chains."""
    same = ((a[0] == b[0]).flatten(1).all(1) & (a[1] == b[1]).flatten(1).all(1)
            & (a[3][..., sl_a] == b[3][..., sl_b]).flatten(1).all(1))
    ok = same.nonzero()[:, 0]
    lv = fit = 0.0
    if len(ok):
        torch.testing.assert_close(a[2][ok], b[2][ok], **LV_TOL,
                                   msg="leaf values")
        torch.testing.assert_close(a[4][ok][..., sl_a], b[4][ok][..., sl_b],
                                   **FIT_TOL, msg="tree fits")
        lv = float((a[2][ok] - b[2][ok]).abs().max())
        fit = float((a[4][ok][..., sl_a] - b[4][ok][..., sl_b]).abs().max())
    return same.cpu().numpy(), max(lv, fit)


def _sharded_rank(rank, world, device, N, C, T, reps, path_shape,
                  regrow=False):
    """Phase 10a in one rank: the sharded kernel on this rank's shard
    against the plain sharded sweep (both all-reducing over the world)
    and against the obs-tiled kernel over the whole n, at (N, C) and at
    the composed path's ``path_shape`` (its n and chains per data group)
    with the K and apply blocks the kernel picks there; rank 0 also times
    them and checks world size 1.  With ``regrow`` (phase 11b), the same
    at (N, C) with p_regrow = 1 against the plain sharded sweep, with its
    regrow updates and all-reduces, and rank 0 times it."""
    import torch.distributed as dist

    from stan4bart_torch.ops.bart_sweep_kernel import (
        apply_blocks, bart_sweep_fused_sharded, sweep_plain,
        sweep_sharded_cuda, sweep_tiled_cuda)
    from stan4bart_torch.parallel.mesh import DataAxis

    # gloo's all_reduce and broadcast take CUDA tensors
    x = torch.full((3,), float(rank + 1), device=device)
    dist.all_reduce(x)
    y = torch.full((3,), float(rank), device=device)
    dist.broadcast(y, 0)
    gloo_cuda = bool((x == world * (world + 1) / 2).all()
                     and (y == 0).all() and x.is_cuda)
    cfg, state, yt, args = sweep_args(N, T, C, 4, device)
    largs, sl = _local_args(args, rank, world)
    axis = DataAxis()
    k = sweep_sharded_cuda(*largs, reduce=axis.sum)
    reductions = axis.calls
    p = sweep_plain(*largs, reduce=axis.sum)
    t = sweep_tiled_cuda(*args)
    torch.cuda.synchronize()
    same_p, err_p = _same_chains(k, p)
    same_t, err_t = _same_chains(k, t, slice(None), sl)
    out = dict(gloo_cuda=gloo_cuda, backend=str(dist.get_backend()),
               same_plain=same_p, err_plain=err_p, same_tiled=same_t,
               err_tiled=err_t, reductions=reductions,
               cluster=bart_sweep_fused_sharded.last_cluster)
    # the composed path's shape (phase 10b's data group)
    N2, C2 = path_shape
    _, _, _, args2 = sweep_args(N2, T, C2, 6, device)
    largs2, sl2 = _local_args(args2, rank, world)
    k2 = sweep_sharded_cuda(*largs2, reduce=axis.sum)
    out.update(path_cluster=bart_sweep_fused_sharded.last_cluster,
               path_apply=apply_blocks(C2, largs2[-1].n_obs))
    p2 = sweep_plain(*largs2, reduce=axis.sum)
    t2 = sweep_tiled_cuda(*args2)
    torch.cuda.synchronize()
    out["path_same_plain"], out["path_err_plain"] = _same_chains(k2, p2)
    out["path_same_tiled"], out["path_err_tiled"] = _same_chains(
        k2, t2, slice(None), sl2)
    del args2, largs2, k2, p2, t2
    # the sweep with its all-reduces, every rank at once (host clock)
    walls = []
    for _ in range(reps):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sweep_sharded_cuda(*largs, reduce=axis.sum)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    out["wall_ms"] = float(np.median(walls))
    out["walls"] = walls
    dist.barrier()
    if rank == 0:
        # one rank on the card at a time: the kernels alone, the plain
        # version, the obs-tiled kernel over the whole n, world size 1
        out["ms"], out["all_ms"] = _time(lambda: sweep_sharded_cuda(*largs),
                                         reps)
        out["plain_ms"] = _time(lambda: sweep_plain(*largs), 3)[0]
        out["tiled_ms"] = _time(lambda: sweep_tiled_cuda(*args), reps)[0]
        w1 = sweep_sharded_cuda(*args)
        torch.cuda.synchronize()
        out["same_w1"], out["err_w1"] = _same_chains(w1, t)
        out["w1_ms"] = _time(lambda: sweep_sharded_cuda(*args), reps)[0]
        out["bound_ms"] = (sweep_bytes(C, T, N // world, cfg.max_nodes)
                           / HBM_BYTES_PER_S * 1e3)
        out["bound_w1_ms"] = (sweep_bytes(C, T, N, cfg.max_nodes)
                              / HBM_BYTES_PER_S * 1e3)
    dist.barrier()
    if regrow:
        lon, rg = regrow_args(largs, 1.0, 104)
        axis = DataAxis()
        before = bart_sweep_fused_sharded.regrow_launches
        kr = sweep_sharded_cuda(*lon, reduce=axis.sum, rg=rg)
        out["rg_updates"] = bart_sweep_fused_sharded.regrow_launches - before
        out["rg_reductions"] = axis.calls
        pr = sweep_plain(*lon, reduce=axis.sum, rg=rg)
        torch.cuda.synchronize()
        out["rg_same"], out["rg_err"] = _same_chains(kr, pr)
        out["rg_moved"] = changed_chains(kr, k)
        del pr
        dist.barrier()
        if rank == 0:
            out["rg_ms"], out["rg_all_ms"] = _time(
                lambda: sweep_sharded_cuda(*lon, rg=rg), reps)
            out["rg_plain_ms"] = _time(lambda: sweep_plain(*lon, rg=rg),
                                       3)[0]
            out["rg_bound_ms"] = (
                (sweep_bytes(C, T, N // world, cfg.max_nodes)
                 + regrow_bytes(C, T, cfg.max_nodes))
                / HBM_BYTES_PER_S * 1e3)
        dist.barrier()
    return out


def phase_sharded_kernel(N=50_000, C=64, T=75, reps=7, label="phase 10a",
                         path_shape=(10_000, 128), regrow=False):
    """The observation-sharded sweep kernel over 2 ranks on the card; with
    ``regrow``, phase 11b in the same ranks."""
    from stan4bart_torch.parallel import mesh

    t0 = time.perf_counter()
    r0, r1 = mesh.spawn(_sharded_rank, ["cuda:0", "cuda:0"], RANK_BACKEND,
                        args=(N, C, T, reps, path_shape, regrow),
                        timeout_s=600)
    same_p = r0["same_plain"] & r1["same_plain"]
    same_t = r0["same_tiled"] & r1["same_tiled"]
    print(f"{label}: backend {r0['backend']}, gloo all_reduce / broadcast "
          f"on CUDA tensors: {r0['gloo_cuda'] and r1['gloo_cuda']}; n={N} "
          f"over 2 ranks, chains={C}, trees={T}, stats K="
          f"{r0['cluster']}: {int(same_p.sum())}/{C} chains identical to "
          f"the plain sharded sweep (max |kernel - plain| "
          f"{max(r0['err_plain'], r1['err_plain']):.3g}), "
          f"{int(same_t.sum())}/{C} to the obs-tiled kernel over the whole "
          f"n (max {max(r0['err_tiled'], r1['err_tiled']):.3g}); "
          f"{r0['reductions']} all-reduces per rank for {T} trees; world "
          f"size 1: {int(r0['same_w1'].sum())}/{C} chains identical to the "
          f"obs-tiled kernel (max {r0['err_w1']:.3g})", flush=True)
    if not (r0["gloo_cuda"] and r1["gloo_cuda"]):
        raise AssertionError(f"{label}: gloo refused CUDA tensors")
    N2, C2 = path_shape
    path_p = r0["path_same_plain"] & r1["path_same_plain"]
    path_t = r0["path_same_tiled"] & r1["path_same_tiled"]
    print(f"{label}: at phase 10b's shape, n={N2} over 2 ranks, chains="
          f"{C2}, trees={T}, stats K={r0['path_cluster']}, apply blocks "
          f"{r0['path_apply']} per chain: {int(path_p.sum())}/{C2} chains "
          "identical to the plain sharded sweep (max |kernel - plain| "
          f"{max(r0['path_err_plain'], r1['path_err_plain']):.3g}), "
          f"{int(path_t.sum())}/{C2} to the obs-tiled kernel over the whole "
          f"n (max {max(r0['path_err_tiled'], r1['path_err_tiled']):.3g})",
          flush=True)
    if (same_p.sum() < C or same_t.sum() < C - 1
            or r0["same_w1"].sum() < C - 1 or r0["reductions"] != T
            or path_p.sum() < C2 or path_t.sum() < C2 - 1):
        raise AssertionError(f"{label}: the sharded kernel disagrees")
    share = 1.0 - r0["ms"] / r0["wall_ms"]
    print(f"{label}: stats + apply kernels per sweep at n={N // 2} per rank "
          f"median {r0['ms']:.4f} ms {[round(x, 4) for x in r0['all_ms']]}; "
          f"the sweep with its {T} all-reduces, both ranks at once, median "
          f"{r0['wall_ms']:.4f} ms (host clock; rank 1 "
          f"{r1['wall_ms']:.4f}), the collectives' share "
          f"{100 * share:.1f} %; obs-tiled kernel over n={N} in the same "
          f"call {r0['tiled_ms']:.4f} ms; the sharded kernel at world size "
          f"1 over n={N} {r0['w1_ms']:.4f} ms; plain sharded sweep "
          f"{r0['plain_ms']:.4f} ms; memory bound {r0['bound_ms']:.4f} ms at "
          f"the local n ({r0['bound_w1_ms']:.4f} ms at n={N}); "
          f"{time.perf_counter() - t0:.1f} s; {card()}", flush=True)
    if regrow:
        same = r0["rg_same"] & r1["rg_same"]
        print(f"phase 11b: the sharded kernel with p_regrow 1 at n={N} over "
              f"2 ranks, chains={C}: {int(same.sum())}/{C} chains identical "
              "to the plain sharded sweep (max |kernel - plain| "
              f"{max(r0['rg_err'], r1['rg_err']):.3g}); the move changed "
              f"{r0['rg_moved']}/{C} chains' forests; per rank "
              f"{T} tree updates and {r0['rg_updates']} regrow updates "
              f"(rank 1 {r1['rg_updates']}), {r0['rg_reductions']} "
              f"all-reduces (rank 1 {r1['rg_reductions']}); kernels alone "
              f"median {r0['rg_ms']:.4f} ms "
              f"{[round(x, 4) for x in r0['rg_all_ms']]} against "
              f"{r0['ms']:.4f} ms at p_regrow 0; plain sharded sweep "
              f"{r0['rg_plain_ms']:.4f} ms; bound {r0['rg_bound_ms']:.4f} "
              f"ms; {card()}", flush=True)
        if (same.sum() < C or r0["rg_updates"] != r1["rg_updates"]
                or r0["rg_reductions"] != T + r0["rg_updates"]):
            raise AssertionError("phase 11b: the sharded kernel with the "
                                 "regrow disagrees")
    return dict(r0, max_abs_err=max(
        r0["err_w1"], *(r[k] for r in (r0, r1) for k in (
            "err_plain", "err_tiled", "path_err_plain", "path_err_tiled"))),
        share=share)


def _digest(fit):
    import hashlib

    h = hashlib.sha256()
    for name in ("stan", "bart_train", "bart_test", "k", "varcount"):
        h.update(np.ascontiguousarray(getattr(fit.draws, name)).tobytes())
    return h.hexdigest()


def _composed_rank(rank, world, device, n, chains, iters, warmup, trees,
                   obs_shards):
    """Phase 10b in one rank: the flagship fit in a world of ``world``
    ranks with ``obs_shards`` data ranks per chain group."""
    import stan4bart_torch
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    d = generate_friedman_data(n, ranef=True, causal=True)
    counts = reset_counts()
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fit = stan4bart_torch.stan4bart(
        FLAGSHIP, friedman_dataframe(d), treatment="z", chains=chains,
        iter=iters, warmup=warmup, seed=11, verbose=-1, device=device,
        stan_args={"max_treedepth": 6, "obs_shards": obs_shards},
        bart_args={"n_trees": trees})
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    out = dict(digest=_digest(fit), launches=launches, wall=wall,
               timings=fit.timings,
               peak=torch.cuda.max_memory_allocated() if on_card else 0,
               info={k: fit.run_info[k] for k in
                     ("world_size", "chain_groups", "obs_shards", "backend",
                      "all_reduces")},
               finite=all(bool(np.all(np.isfinite(getattr(fit.draws, k))))
                          for k in ("stan", "bart_train", "bart_test", "k")))
    if rank == 0:
        z = d["z"]
        out.update(
            cor=centered_cor(fit.fitted("indiv.bart"), d["mu_bart"]),
            sigma=float(fit.fitted("sigma")),
            sate=float(np.mean((fit.fitted("ev")
                                - fit.fitted("ev", sample="test"))
                               * (2 * z - 1))),
            tau=float(d["tau"]))
    return out


def phase_composed(label="phase 10b", n=10_000, chains=256, iters=150,
                   warmup=75, trees=75, device="cuda:0"):
    """The phase 3 fit on 4 ranks: 2 chain groups x obs_shards = 2."""
    from stan4bart_torch.parallel import mesh

    t0 = time.perf_counter()
    res = mesh.spawn(_composed_rank, [device] * 4, RANK_BACKEND,
                     args=(n, chains, iters, warmup, trees, 2),
                     timeout_s=900)
    r0 = res[0]
    want = (iters + 1) * trees
    for r, x in enumerate(res):
        for k, got in x["launches"].items():
            if got != (want if k == "bart_sweep_sharded" else 0):
                raise AssertionError(f"{label}: rank {r} {k} launched {got} "
                                     f"times")
        if x["digest"] != r0["digest"] or not x["finite"]:
            raise AssertionError(f"{label}: rank {r}'s draws differ or are "
                                 "not finite")
    tm = [x["timings"] for x in res]
    print(f"{label}: stan4bart n={n} chains={chains} trees={trees} "
          f"iter={iters} warmup={warmup} on {r0['info']['world_size']} "
          f"ranks ({r0['info']['chain_groups']} chain groups x obs_shards "
          f"{r0['info']['obs_shards']}, backend {r0['info']['backend']}): "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start; "
          "bart_sweep_sharded launches per rank "
          f"{r0['launches']['bart_sweep_sharded']} = ({iters} iterations + 1 "
          f"init) x {trees} trees, other sweep kernels 0; all-reduces per "
          f"rank {r0['info']['all_reduces']}; the gathered draws identical "
          "on every rank; per rank wall s "
          + ", ".join(f"{x['wall']:.1f}" for x in res)
          + "; per-phase s (rank 0..3): NUTS+linear/level Gibbs "
          + "/".join(f"{t['nuts_gibbs']:.1f}" for t in tm) + ", sweep "
          + "/".join(f"{t['sweep']:.1f}" for t in tm) + ", post "
          + "/".join(f"{t['post']:.1f}" for t in tm) + ", gather "
          + "/".join(f"{t['gather']:.1f}" for t in tm)
          + "; peak device memory per rank "
          + ", ".join(f"{x['peak'] / 2 ** 30:.2f}" for x in res)
          + f" GiB; {card()}", flush=True)
    check_gates(label, r0["cor"], r0["sigma"], "bart_sweep_sharded",
                r0["launches"]["bart_sweep_sharded"] // trees, iters)
    print(f"{label}: SATE {r0['sate']:.4f} (truth {r0['tau']}, within 1)",
          flush=True)
    if abs(r0["sate"] - r0["tau"]) >= 1.0:
        raise AssertionError(f"{label}: SATE gate failed")
    return r0["launches"]["bart_sweep_sharded"]


def _contract_rank(rank, world, device, fits):
    """Phase 10c in one rank: each small fit of ``fits`` in turn in the
    world; their draws and launch counts."""
    out = []
    for kw in fits:
        counts = reset_counts()
        fit = _small_fit(device, **kw)
        out.append(dict(
            draws={k: getattr(fit.draws, k) for k in
                   ("stan", "bart_train", "tree_feature", "tree_cut")},
            launches={k: fn.launches for k, fn in counts.items()},
            threads=torch.get_num_threads()))
    return out


def _small_fit(device, seed, n=2000, **kw):
    import stan4bart_torch
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    d = generate_friedman_data(n, ranef=True, causal=True)
    return stan4bart_torch.stan4bart(
        FLAGSHIP, friedman_dataframe(d), treatment="z", iter=20, warmup=10,
        seed=seed, verbose=-1, device=device,
        bart_args={"n_trees": 20, "keep_trees": True}, **kw)


def phase_contracts(device, label="phase 10c", chains=16, n=2000):
    """The chain path's and the obs-sharded path's contracts at n = 2000."""
    from stan4bart_torch.parallel import mesh, multihost

    t0 = time.perf_counter()
    fits = (dict(seed=5, chains=chains, n=n, stan_args={"max_treedepth": 6}),
            dict(seed=6, chains=chains, n=n,
                 stan_args={"max_treedepth": 6, "obs_shards": 2}))
    # the ranks run while this process fits the single-process references
    # (nothing here is timed); the ranks use fewer host threads than this
    # process, which a fit on the card does not see
    box = {}

    def run_ranks():
        try:
            box["ranks"] = mesh.spawn(_contract_rank, [str(device)] * 2,
                                      RANK_BACKEND, args=(fits,),
                                      timeout_s=600)
        except Exception as e:      # raised below, in this thread
            box["error"] = e

    ranks_thread = threading.Thread(target=run_ranks)
    ranks_thread.start()
    C = chains // 2
    refs = [_small_fit(device, seed=multihost.rank_seed(5, r, 2), chains=C,
                       n=n, stan_args={"max_treedepth": 6})
            for r in range(2)]
    ref = _small_fit(device, seed=multihost.rank_seed(6, 0, 1),
                     chains=chains, n=n, stan_args={"max_treedepth": 6})
    ranks_thread.join()
    if "error" in box:
        raise box["error"]
    ranks = box["ranks"]
    res = [r[0] for r in ranks]
    draws = res[0]["draws"]
    for r in range(2):
        for k, v in draws.items():
            if not np.array_equal(v[r * C:(r + 1) * C],
                                  getattr(refs[r].draws, k)):
                raise AssertionError(f"{label}: rank {r}'s {k} differs from "
                                     "the single-process fit")
        if not all(np.array_equal(v, res[1]["draws"][k])
                   for k, v in draws.items()):
            raise AssertionError(f"{label}: the ranks' draws differ")
    chain_batch = res[0]["launches"]["bart_sweep_batch"]
    if chain_batch != 21 or res[0]["launches"]["bart_sweep_sharded"]:
        raise AssertionError(f"{label}: the chain path's launches "
                             f"{res[0]['launches']}")
    print(f"{label}: a 2-rank chain-sharded fit (n={n}, {chains} chains, 20 "
          "iterations, bart_sweep_batch launches per rank "
          f"{chain_batch}) equals, to the bit, "
          f"rank by rank, single-process fits of {C} chains with the "
          f"ranks' seeds (host threads: ranks {res[0]['threads']}, "
          f"single-process fits {torch.get_num_threads()})", flush=True)
    res = [r[1] for r in ranks]
    d = res[0]["draws"]
    same = np.array([
        np.array_equal(d["tree_feature"][c, 0], ref.draws.tree_feature[c, 0])
        and np.array_equal(d["tree_cut"][c, 0], ref.draws.tree_cut[c, 0])
        for c in range(chains)])
    launches = res[0]["launches"]["bart_sweep_sharded"]
    print(f"{label}: a 2-rank obs-sharded fit's first forests equal the "
          f"unsharded fit's in {int(same.sum())}/{chains} chains; "
          f"bart_sweep_sharded launches per rank {launches}; "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    if same.sum() < chains - 1 or launches != 21 * 20:
        raise AssertionError(f"{label}: the obs-sharded fit differs")
    return {"bart_sweep_batch": chain_batch, "bart_sweep_sharded": launches}


def regrow_bytes(C, T, M):
    """Bytes the in-sweep regrow adds to a sweep's bound: its variates
    (3 + 3 M uniforms per chain and tree), read once.  The cut ranks its
    walks read are the ranks table ``sweep_bytes`` counts once already,
    and the leaf indices and residuals it reads are on chip."""
    return C * T * (3 + 3 * M) * 4


def regrow_args(args, p, seed, shut=False):
    """``sweep_args``' operands with ``p_regrow = p`` and regrow variates
    drawn from ``seed`` (every gate shut when ``shut``)."""
    from stan4bart_torch.ops import bart as ops

    cfg = args[0]
    C, T = args[1].shape[:2]
    gen = torch.Generator(device=args[1].device)
    gen.manual_seed(seed)
    rg = ops.draw_tree_regrow_variates(gen, C, cfg, torch.float32,
                                       args[1].device)
    if shut:
        rg[..., 0] = 1.0
    return (cfg._replace(p_regrow=p),) + args[1:], rg


def changed_chains(a, b):
    """How many chains' forests differ between two sweeps' outputs."""
    return int(((a[0] != b[0]).flatten(1).any(1)
                | (a[1] != b[1]).flatten(1).any(1)).sum())


def regrow_at_shape(device, label, N, C, kernels, seed, T=75, times=False,
                    reps=7, weighted=False):
    """Each kernel of ``kernels`` (name -> (launcher, wrapper)) at N x C
    chains, at the K it picks, with p_regrow = 1 against the plain sweep
    on the same (u, zn, rg) variates (identical forests and leaf indices
    in every chain); every gate shut against p_regrow = 0 (to the bit);
    and how many chains' forests the move changed.  ``weighted``: every
    sweep with observation weights drawn in [0.5, 2).  With ``times``,
    the kernels' CUDA-event times at p_regrow = 0, 0.25 and 1 and the
    plain sweep's at 1.  Returns the largest error and the times."""
    from stan4bart_torch.ops.bart_sweep_kernel import sweep_plain

    _, state, yt, args = sweep_args(N, T, C, seed, device)
    w = None
    if weighted:
        gen = torch.Generator(device=device)
        gen.manual_seed(seed + 200)
        w = 0.5 + 1.5 * torch.rand(N, generator=gen, device=device)
    on, rg = regrow_args(args, 1.0, seed + 100)
    shut, rg_shut = regrow_args(args, 0.5, seed + 100, shut=True)
    outs, off, ks, moved = {}, {}, {}, {}
    for name, (launch, wrapper) in kernels.items():
        off[name] = launch(*args, weights=w)
        closed = launch(*shut, weights=w, rg=rg_shut)
        torch.cuda.synchronize()
        if not all(torch.equal(x, y) for x, y in zip(off[name], closed)):
            raise AssertionError(f"{label}: {name} with every regrow gate "
                                 "shut differs from p_regrow = 0")
        outs[name] = launch(*on, weights=w, rg=rg)
        ks[name] = wrapper.last_cluster
        moved[name] = changed_chains(outs[name], off[name])
    outs["plain"] = sweep_plain(*on, weights=w, rg=rg)
    torch.cuda.synchronize()
    res = check_sweep(f"{label} regrow p=1 n={N} chains={C}"
                      + (" weighted" if weighted else ""), outs, state,
                      yt, C, N, T, C)
    print(f"{label} n={N} chains={C}{' weighted' if weighted else ''}: "
          "with every gate shut each kernel "
          "equals its p_regrow = 0 sweep to the bit; at p_regrow = 1 the "
          "move changed the forests of "
          + ", ".join(f"{k} (K={ks[k]}) {v}/{C}" for k, v in moved.items())
          + " chains", flush=True)
    out = dict(err=max(v[1] for v in res.values()), clusters=ks)
    if times:
        mid, rg_mid = regrow_args(args, 0.25, seed + 100)
        for name, (launch, _) in kernels.items():
            for tag, a, r in (("0", args, None), ("0.25", mid, rg_mid),
                              ("1", on, rg)):
                ms, all_ms = _time(lambda: launch(*a, weights=w, rg=r),
                                   reps)
                out[f"{name}_ms_{tag}"] = ms
                out[f"{name}_all_{tag}"] = all_ms
        out["plain_ms_1"] = _time(
            lambda: sweep_plain(*on, weights=w, rg=rg), 3)[0]
    return out


def phase_regrow_kernels(device, reps=7):
    """Phase 11a: the one-launch kernels with the in-sweep regrow at the
    bench shape (timed, with the bound) and at the shapes the main paths
    run (phases 6-9: 10 000 x 128; phase 5: 50 000 x 32), where the
    obs-tiled kernel also runs at K = 1, whose 50 000 rows a block keep
    the residual in device memory (its streaming kernel's regrow step),
    unweighted and weighted."""
    from functools import partial

    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused, bart_sweep_fused_batch,
        bart_sweep_fused_batch_tiled, kernel_smem, sweep_chain_cuda,
        sweep_cuda, sweep_tiled_cuda)

    C, N, T, M = 256, 10_000, 75, 127
    three = {"batch": (sweep_cuda, bart_sweep_fused_batch),
             "tiled": (sweep_tiled_cuda, bart_sweep_fused_batch_tiled),
             "chain": (sweep_chain_cuda, bart_sweep_fused)}
    bench = regrow_at_shape(device, "phase 11a", N, C, three, 3, T,
                            times=True, reps=reps)
    at128 = regrow_at_shape(
        device, "phase 11a", N, 128,
        {k: three[k] for k in ("batch", "chain")}, 6, T)
    if kernel_smem("bart_sweep_tiled", 50_000, T, 1, True)["resid_on_chip"]:
        raise AssertionError("phase 11a: the obs-tiled kernel at 50 000 "
                             "rows a block keeps the residual on chip; "
                             "its streaming kernel would go unchecked")
    at50k = {"tiled": three["tiled"],
             "tiled streamed": (partial(sweep_tiled_cuda, cluster=1),
                                bart_sweep_fused_batch_tiled)}
    at50k = [regrow_at_shape(device, "phase 11a", 50_000, 32, at50k, 7, T,
                             weighted=wt) for wt in (False, True)]
    print("phase 11a " + smem_note("bart_sweep_tiled", 50_000, T, 1, True),
          flush=True)
    nbytes = sweep_bytes(C, T, N, M) + regrow_bytes(C, T, M)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    lines = "; ".join(
        f"{k} (K={bench['clusters'][k]}) p_regrow 0 / 0.25 / 1: "
        f"{bench[k + '_ms_0']:.4f} / {bench[k + '_ms_0.25']:.4f} / "
        f"{bench[k + '_ms_1']:.4f} ms" for k in three)
    print("phase 11a " + "; ".join(
        smem_note(f"bart_sweep_{k}", N, T, bench["clusters"][k], True)
        for k in three), flush=True)
    print(f"phase 11a times at n={N} chains={C} trees={T}, median of "
          f"{reps}: {lines}; batch at p_regrow 1 "
          f"{[round(t, 4) for t in bench['batch_all_1']]}; plain sweep at "
          f"p_regrow 1 {bench['plain_ms_1']:.4f} ms; bound with the move "
          f"{bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s; the regrow variates "
          f"{regrow_bytes(C, T, M) / 1e6:.1f} MB); {card()}", flush=True)
    return dict(bench, bound_ms=bound_ms,
                max_abs_err=max(bench["err"], at128["err"],
                                *(r["err"] for r in at50k)))


def phase_regrow_fit(device, label="phase 11c", n=10_000, chains=128,
                     iters=150, warmup=75, trees=75, p_regrow=0.25):
    """Phase 11c: the phase 3 fit (at 128 chains) with the in-sweep
    regrow, every sweep through the single-pass kernel with the move: the
    gaussian gates and SATE."""
    from stan4bart_torch.ops.bart_sweep_kernel import bart_sweep_fused_batch

    d, fit, launches = run_fit(label, device, n, chains, "bart_sweep_batch",
                               iters, warmup, trees,
                               bart_args={"n_trees": trees,
                                          "p_regrow": p_regrow})
    regrown = bart_sweep_fused_batch.regrow_launches
    finite_draws(label, fit)
    if fit.prog.bart_cfg.p_regrow != p_regrow or regrown != launches:
        raise AssertionError(f"{label}: {regrown} of {launches} launches "
                             "ran the regrow")
    cor = centered_cor(fit.fitted("indiv.bart"), d["mu_bart"])
    check_gates(label, cor, float(fit.fitted("sigma")), "bart_sweep_batch",
                launches, iters)
    z = d["z"]
    sate = float(np.mean((fit.fitted("ev") - fit.fitted("ev", sample="test"))
                         * (2 * z - 1)))
    print(f"{label}: p_regrow {p_regrow}, {regrown} launches with the move; "
          f"SATE {sate:.4f} (truth {d['tau']}, within 1)", flush=True)
    if abs(sate - d["tau"]) >= 1.0:
        raise AssertionError(f"{label}: SATE gate failed")
    return launches


def phase_profile(device, fit3=None, label="phase 11d", n=10_000,
                  chains=256, trees=75):
    """Phase 11d: ``utils.profiling.profile_phases`` at the bench shape
    (n_iter 3, repeats 1) on phase 3's final states, or on a short fit's
    when phase 3 did not run; prints ``format_profile``'s lines."""
    from stan4bart_torch.utils.profiling import format_profile, profile_phases

    if fit3 is None:
        _, fit3, _ = run_fit(f"{label} states", device, n, chains,
                             "bart_sweep_batch", 4, 2, trees)
    t0 = time.perf_counter()
    p = profile_phases(fit3.prog, fit3.final_states, n_iter=3, repeats=1)
    print(f"{label}: profile_phases at n={n} chains={chains} trees={trees} "
          f"({time.perf_counter() - t0:.1f} s); {card()}\n"
          + format_profile(p), flush=True)
    return p


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7,8,9,10,11",
                    help="comma-separated phases to run (default all); "
                    "1, 2, 4, 10a, 11a and 11b are the kernel phases, "
                    "which the kernels line needs; 10a, 10b, 10c and 11a "
                    "to 11d run one part of phase 10 or 11")
    args = ap.parse_args()
    run = set(args.phases.split(","))
    if "10" in run:
        run |= {"10a", "10b", "10c"}
    if "11" in run:
        run |= {"11a", "11b", "11c", "11d"}

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from stan4bart_torch.ops import cuda_build
    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused_batch_tiled, sweep_tiled_cuda)
    from stan4bart_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    walls, clock = {}, [time.perf_counter()]

    def lap(name):
        """Wall seconds since the last lap, under ``name``."""
        now = time.perf_counter()
        walls[name] = now - clock[0]
        clock[0] = now

    secs = cuda_build.build(list(KERNELS), verbose=True)
    lap("build")
    print("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f" ({walls['build']:.1f} s in all)", flush=True)

    err = [0.0, 0.0, 0.0]     # batch, tiled, chain vs plain
    if "1" in run:
        for n in (2000, 9191):
            err = [max(a, b) for a, b in zip(err, phase_small(device, n))]
        lap("phase 1")
    if "2" in run:
        full = phase_full(device)
        ablate = {c: phase_ablate(device, c) for c in (256, 64)}
        lap("phase 2")
    # launches of each kernel on each main path that ran it
    paths = {k: {} for k in KERNELS}
    t3 = None     # phase 3's per-phase seconds, printed beside phase 8's
    fit3 = ev7 = None     # phase 3's fit and phase 7's P(y = 1), for 9
    if "3" in run:
        # run_fit holds every main path to 0 launches of the stubs
        paths["bart_sweep_batch"]["phase 3"], fit3 = phase_main(
            device, "phase 3", 10_000, 256, "bart_sweep_batch")
        t3 = dict(fit3.timings, iters=fit3.draws.stan.shape[1])
        if not {"9", "11d"} & run:   # 9 adjudicates it, 11d profiles it
            fit3 = None
        lap("phase 3")
    if "4" in run:
        large = {n: phase_large(device, n, c)
                 for n, c in ((50_000, 64), (51_840, 64), (200_000, 16))}
        # phase 5 runs its fit at 32 chains
        large[50_000]["max_abs_err_c32"] = hold_at_path_shape(
            device, "phase 4", 50_000, 32,
            {"tiled": (sweep_tiled_cuda, bart_sweep_fused_batch_tiled)},
            seed=7)["tiled"]
        lap("phase 4")
    if "5" in run:
        paths["bart_sweep_tiled"]["phase 5"], _ = phase_main(
            device, "phase 5", 50_000, 32, "bart_sweep_tiled", iters=225,
            warmup=150)
        lap("phase 5")
    if "6" in run:
        paths["bart_sweep_chain"]["phase 6"] = phase_chain(device)
        lap("phase 6")
        paths["bart_sweep_chain"]["phase 6 options"] = phase_options(device)
        paths["bart_sweep_batch"]["phase 6 offset types"] = \
            phase_offset_types(device)
        lap("phase 6 options")
    if "7" in run:
        paths["bart_sweep_batch"]["phase 7"], ev7 = phase_probit(device)
        lap("phase 7")
    if "8" in run:
        paths["bart_sweep_batch"]["phase 8"] = phase_all_options(device, t3)
        lap("phase 8")
        for k, v in phase_option_fits(device).items():
            paths[k]["phase 8 options"] = v
        lap("phase 8 options")
    if "9" in run:
        paths["bart_sweep_batch"]["phase 9"] = phase_algorithms(
            device, t3, fit3, ev7)
        lap("phase 9")
        for k, v in phase_algorithm_options(device).items():
            paths[k]["phase 9 options"] = v
        lap("phase 9 options")
    p11 = None     # phase 3's fit, profiled by 11d
    if "11d" in run and fit3 is not None:
        p11 = fit3
    del fit3
    # phase 10's ranks are processes of their own on the card; 11b runs
    # in 10a's
    torch.cuda.empty_cache()
    sharded = None
    if "10a" in run or "11b" in run:
        sharded = phase_sharded_kernel(regrow="11b" in run)
        lap("phase 10a" + (" and 11b" if "11b" in run else ""))
    if "10b" in run:
        paths["bart_sweep_sharded"]["phase 10b"] = phase_composed()
        lap("phase 10b")
    if "10c" in run:
        for k, v in phase_contracts(device).items():
            paths[k]["phase 10c"] = v
        lap("phase 10c")
    regrow = None
    if "11a" in run:
        regrow = phase_regrow_kernels(device)
        lap("phase 11a")
    if "11c" in run:
        n11 = phase_regrow_fit(device)
        paths["bart_sweep_batch"]["phase 11c"] = n11
        paths["bart_sweep_regrow"] = {"phase 11c": n11}
        lap("phase 11c")
    if "11d" in run:
        phase_profile(device, p11)
        del p11
        lap("phase 11d")
    print("wall seconds by phase: " + ", ".join(
        f"{k} {v:.1f}" for k, v in walls.items())
        + f"; {sum(walls.values()):.1f} in all", flush=True)
    launches = {k: (sum(v.values()) if run - {"1", "2", "4", "10a", "11a",
                                              "11b"}
                    else None)
                for k, v in paths.items()}
    if not {"1", "2", "4", "11a", "11b"} <= run or sharded is None:
        print(card(), flush=True)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return

    big = large[50_000]
    chain_errs = [err[2], full["chain_max_abs_err"]] + [
        r["chain_max_abs_err"] for r in large.values()
        if "chain_max_abs_err" in r]
    print(json.dumps({"kernels": [{
        "name": "bart_sweep_batch",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_batch.cu",
        "replaces": "stan4bart_tpu/ops/bart_sweep_kernel.py:859",
        "launches": launches["bart_sweep_batch"],
        "launches_by_path": paths["bart_sweep_batch"],
        "max_abs_err": max(err[0], full["max_abs_err"]),
        "ms": full["ms"],
        "kernel_ms": full["ms"],
        "plain_ms": full["plain_ms"],
        "bound_ms": full["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": full["cluster"],
    }, {
        "name": "bart_sweep_tiled",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_tiled.cu",
        "replaces": "stan4bart_tpu/ops/bart_sweep_kernel.py:1495",
        "launches": launches["bart_sweep_tiled"],
        "launches_by_path": paths["bart_sweep_tiled"],
        "max_abs_err": max([err[1], full["tiled_max_abs_err"],
                            big["max_abs_err_c32"]]
                           + [r["max_abs_err"] for r in large.values()]),
        "ms": big["ms"],
        "kernel_ms": big["ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": big["cluster"],
        "ms_n200000_c16": large[200_000]["ms"],
        "bound_ms_n200000_c16": large[200_000]["bound_ms"],
        "cluster_n200000_c16": large[200_000]["cluster"],
    }, {
        "name": "bart_sweep_chain",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_chain.cu",
        "replaces": "stan4bart_tpu/ops/bart_sweep_kernel.py:596",
        "launches": launches["bart_sweep_chain"],
        "launches_by_path": paths["bart_sweep_chain"],
        "max_abs_err": max(chain_errs),
        "ms": big["chain_ms"],
        "kernel_ms": big["chain_ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": big["chain_cluster"],
        "ms_n51840_c64": large[51_840]["chain_ms"],
        "bound_ms_n51840_c64": large[51_840]["bound_ms"],
        "cluster_n51840_c64": large[51_840]["chain_cluster"],
        "ms_bench": full["chain_ms"],
        "bound_ms_bench": full["bound_ms"],
        "cluster_bench": full["chain_cluster"],
    }, {
        "name": "bart_sweep_ablate",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_ablate.cu",
        "replaces": "benchmarks/ablate_batch_kernel.py:124",
        "launches": launches["bart_sweep_ablate"],
        "launches_by_path": paths["bart_sweep_ablate"],
        "max_abs_err": max(a["max_abs_err"] for a in ablate.values()),
        "ms": ablate[256]["obs"],
        "kernel_ms": ablate[256]["obs"],
        "copy_ms": ablate[256]["copy"],
        "full_ms": ablate[256]["full"],
        "ms_c64": {k: ablate[64][k] for k in ("copy", "obs", "full")},
        "plain_ms": ablate[256]["plain_ms"],
        "bound_ms": ablate[256]["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": ablate[256]["cluster"],
    }, {
        "name": "bart_sweep_sharded",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_sharded.cu",
        # no Pallas kernel: the JAX package's XLA bart_sweep(axis_name=)
        "replaces": "stan4bart_tpu/ops/bart.py:717",
        # tree updates per rank (one stats and one apply launch each)
        "launches": launches["bart_sweep_sharded"],
        "launches_by_path": paths["bart_sweep_sharded"],
        "max_abs_err": sharded["max_abs_err"],
        "ms": sharded["ms"],
        "kernel_ms": sharded["ms"],
        "plain_ms": sharded["plain_ms"],
        "bound_ms": sharded["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": sharded["cluster"],
        "sweep_wall_ms_2_ranks": sharded["wall_ms"],
        "collective_share": sharded["share"],
        "tiled_ms_same_call": sharded["tiled_ms"],
        "ms_world_size_1": sharded["w1_ms"],
        "bound_ms_world_size_1": sharded["bound_w1_ms"],
    }, {
        # the in-sweep regrow step: no Pallas kernel (the JAX package's
        # move is XLA); it runs inside the one-launch kernels and, sharded,
        # as a regrow stats and a regrow apply launch
        "name": "bart_sweep_regrow",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/sweep_common.cuh",
        "replaces": "stan4bart_tpu/ops/bart.py:531",
        # single-pass kernel launches that ran the move, on its fit path
        "launches": launches.get("bart_sweep_regrow"),
        "launches_by_path": paths.get("bart_sweep_regrow", {}),
        "max_abs_err": max(regrow["max_abs_err"], sharded["rg_err"]),
        "ms": regrow["batch_ms_1"],
        "kernel_ms": regrow["batch_ms_1"],
        "ms_p_regrow_0": regrow["batch_ms_0"],
        "ms_p_regrow_0.25": regrow["batch_ms_0.25"],
        "tiled_ms": regrow["tiled_ms_1"],
        "chain_ms": regrow["chain_ms_1"],
        "plain_ms": regrow["plain_ms_1"],
        "bound_ms": regrow["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "cluster": regrow["clusters"]["batch"],
        "sharded_ms": sharded["rg_ms"],
        "sharded_plain_ms": sharded["rg_plain_ms"],
        "sharded_bound_ms": sharded["rg_bound_ms"],
        "sharded_regrow_updates": sharded["rg_updates"],
    }]}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

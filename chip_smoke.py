"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card
    python3 chip_smoke.py --kernels  # build + kernel phases 1, 2 and 4 only

Builds the port's four CUDA kernel sources from ``stan4bart_torch/csrc``
with nvcc (one process per source, started together), then:

1. holds every sweep kernel against their plain PyTorch version at small
   sizes (20 trees, 16 chains, 3 chained sweeps, unweighted, weighted and
   a probit-style target), at n = 2000 and at n = 9191, which is not a
   multiple of any tile: the single-pass and obs-tiled kernels at every
   cluster size K = 1, 2, 4, 8 (blocks per chain) and the per-chain
   kernel; identical forests, leaf values and fits within float32
   tolerance; single-pass and obs-tiled equal to the bit at every K, and
   equal to the per-chain kernel to the bit at K = 1;
2. does the same at the bench shape (n = 10000, 75 trees, 9 BART
   variables, 256 chains, one sweep from a prior-drawn forest), prints
   each kernel's K and shared memory per block and times the kernels and
   the plain version with CUDA events; then holds the ablation stubs of
   the single-pass kernel (copy, obs) against their plain versions and
   times copy, obs and the full kernel at 256 and at 64 chains;
3. runs the single-pass kernel's main path: ``stan4bart_torch.stan4bart``
   on the flagship Friedman model at n = 10000 with 256 chains on the card
   (150 iterations, 75 of them warmup), checks that every sweep went
   through that kernel, that the draws are finite and that the fit passes
   the reference's quality gates, and prints the K it used;
4. holds the obs-tiled kernel, at its default K and at K = 1 (residual in
   device memory), against the plain version at the reference's large-n
   shapes (n = 50000 with 64 chains, n = 200000 with 16 chains; 75
   trees, 9 variables) and times them; at n = 50000 and at the per-chain
   kernel's shared-memory ceiling, n = 51840 (64 chains), also the
   per-chain kernel, against the plain version and to the bit against
   the obs-tiled one at K = 1, with its shared memory per block;
5. runs the obs-tiled kernel's main path: the same fit at n = 50000 with
   64 chains, every sweep through the obs-tiled kernel, with the same
   checks.  It runs 300 iterations, 150 of them warmup: at n = 50000
   the chains' sigma needs about 150-225 iterations to come down from
   its start (the 25-iteration blocks it prints show it), and at 150 /
   75 the posterior-mean sigma misses the gate;
6. runs the per-chain path: the phase 3 fit with ``keep_fits=False`` and
   a callback returning each draw's sigma and BART fit, so every
   iteration is ``GibbsProgram.step`` and every sweep the per-chain
   kernel; no raw draws may be stored, and the quality gates are computed
   from the callback's outputs; then a short per-chain fit on the card
   (n = 2000, 16 chains, 40 iterations) with the options that path
   serves: a callback beside the raw draws, pooled adaptation of stepsize
   and metric, and the chi(df, scale) hyperprior on k.

Prints the card (``nvidia-smi``), a ``{"kernels": [...]}`` line, and as
its last line ``{"ok": true, "device": {...}}``.  Any failure raises and
exits non-zero.  Needs no network; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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
           "bart_sweep_ablate")

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
    """The three kernels (through their wrappers) vs plain, the two
    chain-batched ones at every cluster size K, 3 chained sweeps per case;
    to the bit: batch and obs-tiled at equal K, and both at K = 1 with the
    per-chain kernel.  Returns the max |kernel - plain| of each kernel."""
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
        runs = {"chain": state, "plain": state}
        runs.update({(kind, K): state for kind in ("batch", "tiled")
                     for K in CLUSTERS})
        for sweep in range(3):
            var = ops.draw_variates(gen, C, cfg.num_trees, torch.float32,
                                    device)
            vc = {}
            for key, st in runs.items():
                kw = dict(weights=w, variates=var)
                if key == "chain":
                    runs[key], vc[key] = bart_sweep_fused(
                        cfg, st, target, consts, sigma, None, **kw)
                elif key == "plain":
                    # the plain version on the same card and inputs
                    out = sweep_plain(
                        cfg, st.feature, st.cut, st.leaf_idx, st.tree_fit,
                        (target - st.allfit).contiguous(), sigma * sigma,
                        st.sigma_mu * st.sigma_mu, var[0], var[1], consts,
                        weights=w)
                    runs[key] = as_state(st, out, target)
                    vc[key] = ops.count_variable_use(out[0], P)
                else:
                    fn = (bart_sweep_fused_batch if key[0] == "batch"
                          else bart_sweep_fused_batch_tiled)
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
                kind = key if key == "chain" else key[0]
                err[kind] = max(err[kind], e)
            pairs = [(("tiled", K), ("batch", K)) for K in CLUSTERS]
            pairs.append(("chain", ("batch", 1)))
            for a, b in pairs:
                if not bit_equal(runs[a], runs[b]):
                    raise AssertionError(f"{tag}: {a} and {b} not equal to "
                                         "the bit")
        print(f"phase 1 n={n} {case}: 3 sweeps, {C}/{C} chains identical "
              f"(batch and tiled at K = {CLUSTERS}, and chain, vs plain; "
              "tiled equal to batch to the bit at every K, chain to batch "
              "at K = 1), internal nodes "
              f"{int((runs[('tiled', 1)].feature >= 0).sum())}", flush=True)
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


def smem_note(name, N, T, K):
    """One line on kernel ``name``'s shared memory per block at K."""
    from stan4bart_torch.ops.bart_sweep_kernel import kernel_smem

    m = kernel_smem(name, N, T, K)
    where = "on chip" if m["resid_on_chip"] else "in device memory"
    return (f"{name} K={K}: {m['static']} B static + {m['dynamic']} B "
            f"dynamic shared memory per block of the {m['optin']} B opt-in "
            f"limit, {m['clusters']} clusters resident at once, residual "
            f"{where}")


def phase_full(device, reps=7, C=256, N=10_000, T=75):
    """The three kernels vs plain at the bench shape, and their times."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        bart_sweep_fused_batch, bart_sweep_fused_batch_tiled, kernel_smem,
        sweep_chain_cuda, sweep_cuda, sweep_plain, sweep_tiled_cuda)

    cfg, state, yt, args = sweep_args(N, T, C, 3, device)
    outs = {"batch": sweep_cuda(*args), "tiled": sweep_tiled_cuda(*args),
            "chain": sweep_chain_cuda(*args), "plain": sweep_plain(*args)}
    torch.cuda.synchronize()
    kb = bart_sweep_fused_batch.last_cluster
    kt = bart_sweep_fused_batch_tiled.last_cluster
    res = check_sweep("phase 2", outs, state, yt, C, N, T, C - 1)
    for label in ("tiled", "chain"):
        same = all(torch.equal(x, y) for x, y in zip(outs["batch"],
                                                     outs[label]))
        print(f"phase 2: {label} and batch outputs bit-identical: {same}",
              flush=True)
        if not same:
            raise AssertionError(f"phase 2: {label} differs from batch")
    del outs

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
          f"{smem_note('bart_sweep_tiled', N, T, kt)}", flush=True)
    print(f"phase 2 times over {reps} reps: batch kernel (K={kb}) median "
          f"{b_ms:.4f} ms {[round(t, 4) for t in b_all]}; tiled kernel "
          f"(K={kt}) median {t_ms:.4f} ms {[round(t, 4) for t in t_all]}; "
          f"chain kernel median {c_ms:.4f} ms "
          f"{[round(t, 4) for t in c_all]}; plain median {p_ms:.4f} ms; "
          f"memory bound {bound_ms:.4f} ms ({nbytes / 1e9:.4f} GB at "
          f"{HBM_BYTES_PER_S / 1e12} TB/s), {nbytes / bw * 1e3:.4f} ms at "
          f"the measured copy rate {bw / 1e12:.3f} TB/s; {card()}",
          flush=True)
    return dict(ms=b_ms, plain_ms=p_ms, bound_ms=bound_ms,
                max_abs_err=res["batch"][1], cluster=kb,
                tiled_ms=t_ms, tiled_max_abs_err=res["tiled"][1],
                chain_ms=c_ms, chain_max_abs_err=res["chain"][1])


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
    per-chain one where it runs, vs plain at a large-n shape, and their
    times; the per-chain kernel to the bit against the obs-tiled one at
    K = 1."""
    from stan4bart_torch.ops.bart_sweep_kernel import (
        MAX_CLUSTER, MAX_N_CHAIN, bart_sweep_fused_batch_tiled,
        chain_smem_bytes, kernel_smem, sweep_chain_cuda, sweep_plain,
        sweep_tiled_cuda)

    chain = N <= MAX_N_CHAIN
    cfg, state, yt, args = sweep_args(N, T, C, 4, device)
    outs = {"tiled": sweep_tiled_cuda(*args)}
    K = bart_sweep_fused_batch_tiled.last_cluster
    outs["tiled K=1"] = sweep_tiled_cuda(*args, cluster=1)
    outs["plain"] = sweep_plain(*args)
    if chain:
        outs["chain"] = sweep_chain_cuda(*args)
    torch.cuda.synchronize()
    res = check_sweep(f"phase 4 n={N}", outs, state, yt, C, N, T, C - 1)
    out = dict(max_abs_err=max(res["tiled"][1], res["tiled K=1"][1]),
               cluster=K)
    print(f"phase 4 n={N} {smem_note('bart_sweep_tiled', N, T, K)}; "
          f"{smem_note('bart_sweep_tiled', N, T, 1)}", flush=True)
    if chain:
        same = all(torch.equal(x, y) for x, y in zip(outs["tiled K=1"],
                                                     outs["chain"]))
        st, dy, optin = chain_smem_bytes(N)
        print(f"phase 4 n={N}: chain and tiled (K=1) outputs bit-identical: "
              f"{same}; chain kernel shared memory per block {st} B static "
              f"+ {dy} B dynamic = {st + dy} B of the {optin} B opt-in "
              "limit", flush=True)
        if not same:
            raise AssertionError(f"phase 4 n={N}: chain differs from tiled")
        out.update(chain_max_abs_err=res["chain"][1], smem=(st, dy, optin))
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
        msg += (f"; chain kernel median {out['chain_ms']:.4f} ms "
                f"{[round(t, 4) for t in c_all]}")
    # the obs-tiled kernel at every cluster size, for the cluster rule
    scan = []
    for k in range(1, MAX_CLUSTER + 1):
        m = kernel_smem("bart_sweep_tiled", N, T, k)
        ms = _time(lambda: sweep_tiled_cuda(*args, cluster=k), 3)[0]
        scan.append(f"K={k} {ms:.4f} ms ({m['clusters']} clusters resident"
                    f"{', residual on chip' if m['resid_on_chip'] else ''})")
    print(f"phase 4 n={N} chains={C}: tiled kernel by K, median of 3: "
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
        bart_sweep_fused_batch_tiled)

    return {"bart_sweep_batch": bart_sweep_fused_batch,
            "bart_sweep_tiled": bart_sweep_fused_batch_tiled,
            "bart_sweep_chain": bart_sweep_fused,
            "bart_sweep_ablate": bart_sweep_ablate}


def run_fit(label, device, n, chains, kernel, iters, warmup, trees,
            **fit_kw):
    """The flagship fit at full width through the user entry point, with
    the launch counts read just after it: every sweep must launch
    ``kernel`` and no other sweep kernel."""
    import stan4bart_torch
    from stan4bart_torch.utils.friedman import (
        friedman_dataframe, generate_friedman_data)

    counts = launch_counters()
    d = generate_friedman_data(n, ranef=True, causal=True)
    df = friedman_dataframe(d)
    for fn in counts.values():
        fn.launches = 0
    t0 = time.perf_counter()
    kw = dict(stan_args={"max_treedepth": 6}, bart_args={"n_trees": trees})
    kw.update(fit_kw)
    fit = stan4bart_torch.stan4bart(
        FLAGSHIP, df, treatment="z", chains=chains, iter=iters,
        warmup=warmup, seed=11, verbose=-1, device=device, **kw)
    wall = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counts.items()}
    expected = iters * fit.prog.skip_bart + 1
    for k, got in launches.items():
        want = expected if k == kernel else 0
        if got != want:
            raise AssertionError(f"{label}: {k} launched {got} times, "
                                 f"expected {want}")
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
    return d, fit, launches[kernel]


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
    return launches


def phase_chain(device, label="phase 6", n=10_000, chains=256, iters=150,
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
    draws, pooled adaptation of stepsize and metric, and k ~ chi(1.25):
    the callback's sigma must equal extract('sigma'), k must move, and
    the chains must share one stepsize and metric after warmup."""
    import stan4bart_torch

    def callback(draw):
        return {"sigma": draw["aux.1"]}

    d, fit, launches = run_fit(
        label, device, n, chains, "bart_sweep_chain", iters, warmup, trees,
        callback=callback,
        stan_args={"max_treedepth": 6, "pooled_adaptation": True,
                   "pooled_parts": "both"},
        bart_args={"n_trees": trees, "k": stan4bart_torch.chi(1.25)})
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kernels", action="store_true",
                    help="build and run kernel phases 1, 2 and 4 only")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        sys.exit(2)
    from stan4bart_torch.ops import cuda_build
    from stan4bart_torch.utils.device import resolve_device

    device = resolve_device("cuda")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"cuda {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    secs = cuda_build.build(list(KERNELS), verbose=True)
    print("build: " + ", ".join(f"{k} {v:.1f} s" for k, v in secs.items())
          + f" ({time.perf_counter() - t0:.1f} s in all)", flush=True)

    err = [0.0, 0.0, 0.0]     # batch, tiled, chain vs plain
    for n in (2000, 9191):
        err = [max(a, b) for a, b in zip(err, phase_small(device, n))]
    full = phase_full(device)
    ablate = {c: phase_ablate(device, c) for c in (256, 64)}
    launches = {k: None for k in KERNELS}
    if not args.kernels:
        # run_fit holds every main path to 0 launches of the stubs
        launches["bart_sweep_ablate"] = 0
        launches["bart_sweep_batch"] = phase_main(
            device, "phase 3", 10_000, 256, "bart_sweep_batch")
    large = {n: phase_large(device, n, c)
             for n, c in ((50_000, 64), (51_840, 64), (200_000, 16))}
    if not args.kernels:
        launches["bart_sweep_tiled"] = phase_main(
            device, "phase 5", 50_000, 64, "bart_sweep_tiled", iters=300,
            warmup=150)
        launches["bart_sweep_chain"] = phase_chain(device)
        phase_options(device)

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
        "max_abs_err": max([err[1], full["tiled_max_abs_err"]]
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
        "max_abs_err": max(chain_errs),
        "ms": big["chain_ms"],
        "kernel_ms": big["chain_ms"],
        "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
    }, {
        "name": "bart_sweep_ablate",
        "route": "cuda",
        "source": "stan4bart_torch/csrc/bart_sweep_ablate.cu",
        "replaces": "benchmarks/ablate_batch_kernel.py:124",
        "launches": launches["bart_sweep_ablate"],
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
    }]}), flush=True)
    print(card(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()

"""Observation sharding in the port (``stan_args={"obs_shards": k}``,
parallel/mesh.py) against the JAX package's sharded sweep and against the
port's own unsharded fit.

Two gloo ranks on the CPU (``mesh.spawn``, one world for the module) run:
the plain observation-sharded sweep on shared variates, held to the JAX
package's ``bart_sweep(axis_name="data")`` over the same two shards
(``jax.vmap`` with the axis name: identical forests, values within 1e-9 in
float64); and tiny obs-sharded fits (gaussian, probit, weighted, an odd n
that pads, chunked and whole), held to the unsharded fit of the same
chain group's seed at the JAX test's tolerance (rtol 1e-6, atol 1e-8 over
3 iterations in float64: the sums are taken in another order, and no
decision may flip).  The refusals and the one reduction per tree update
are checked as the JAX package's tests/test_obs_sharding.py checks them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.ops import bart as tb
from stan4bart_torch.parallel import _mh_worker as worker
from stan4bart_torch.parallel import mesh, multihost
from stan4bart_tpu.ops import bart as jb

TOL = dict(rtol=1e-9, atol=1e-9)
FIT_TOL = dict(rtol=1e-6, atol=1e-8)
N, P, T, C = 64, 4, 6, 3
OBS = {"obs_shards": 2}
# three iterations in float64, as the JAX test runs them
FIT3 = dict(iter=3, warmup=2, chains=2, seed=43, stan_args=OBS)
FITS = {"gaussian": dict(n=64), "probit": dict(n=64, binary=True),
        "weighted": dict(n=64, weights=True), "padded": dict(n=61)}
CHUNK = dict(iter=10, warmup=4, chains=2, seed=9, stan_args=OBS)


def _sweep_inputs(weighted: bool, seed: int = 1):
    """A prior forest, data and variates of one sweep, as numpy."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(N, P))
    y = np.sin(X[:, 0]) + X[:, 1] ** 2 + rng.normal(scale=0.5, size=N)
    cfg = tb.BartConfig(num_trees=T, max_depth=4)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(P, 1.0 / P)
    gen = torch.Generator()
    gen.manual_seed(seed)
    st = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks), sp, C,
                                    dtype=torch.float64)
    out = {k: getattr(st, k).numpy() for k in
           ("feature", "cut", "leaf_value", "leaf_idx", "allfit",
            "tree_fit")}
    out.update(cfg=cfg._asdict(), y=y, ranks=ranks, split_probs=sp,
               sigma=np.array([0.7, 0.9, 1.1]),
               sigma_mu=np.full(C, 0.5 / (2 * np.sqrt(T))),
               u=rng.uniform(size=(C, T, 8)), zn=rng.normal(size=(C, T, 128)))
    if weighted:
        out["weights"] = rng.uniform(0.5, 2.0, N)
    return out


@pytest.fixture(scope="module")
def world():
    """One 2-rank gloo world for every multi-process case of the file."""
    cases = [("sweep_case", dict(key="sweep", inputs=_sweep_inputs(False))),
             ("sweep_case", dict(key="sweep_w",
                                 inputs=_sweep_inputs(True, 2)))]
    cases += [("fit_case", dict(FIT3, key=k, **kw)) for k, kw in FITS.items()]
    cases += [("fit_case", dict(CHUNK, key="whole")),
              ("fit_case", dict(CHUNK, key="chunked", chunk_size=3)),
              ("refusal_case", dict(key="refusals"))]
    return mesh.spawn(worker.run_cases, ["cpu", "cpu"], "gloo",
                      args=(cases,), timeout_s=120)


def _jax_sharded_sweep(inp):
    """The JAX package's sweep with axis_name="data" over the two shards
    of ``inp``: an outer vmap over the shards carries the axis name, an
    inner vmap the chains."""
    cfg = jb.BartConfig(**{k: v for k, v in inp["cfg"].items()
                           if k in jb.BartConfig._fields})
    S, n = 2, N // 2
    shard = lambda a: jnp.asarray(np.stack(np.split(a, S, axis=-1)))  # noqa: E731
    rep = lambda a: jnp.asarray(np.broadcast_to(a, (S,) + a.shape))  # noqa: E731
    state = jb.BartState(
        feature=rep(inp["feature"]), cut=rep(inp["cut"]),
        leaf_value=rep(inp["leaf_value"]), leaf_idx=shard(inp["leaf_idx"]),
        allfit=shard(inp["allfit"]), k=rep(np.full(C, 2.0)),
        sigma_mu=rep(inp["sigma_mu"]), tree_fit=shard(inp["tree_fit"]))
    y = shard(inp["y"])
    ranks = jnp.asarray(np.stack(np.split(inp["ranks"], S, axis=0)))
    w = inp.get("weights")
    w_sh = shard(w) if w is not None else jnp.zeros((S, n))

    def one_shard(st, y_s, rk_s, w_s):
        return jax.vmap(lambda s, sg, uu, zz: jb.bart_sweep(
            cfg, s, y_s, rk_s, jnp.asarray(inp["split_probs"]), sg,
            jax.random.PRNGKey(0), weights=None if w is None else w_s,
            variates=(uu, zz), axis_name="data")[0])(
                st, jnp.asarray(inp["sigma"]), jnp.asarray(inp["u"]),
                jnp.asarray(inp["zn"]))

    return jax.jit(jax.vmap(one_shard, axis_name="data"))(state, y, ranks,
                                                          w_sh)


@pytest.mark.parametrize("key", ["sweep", "sweep_w"])
def test_plain_sharded_sweep_matches_the_jax_sharded_sweep(world, key):
    inp = _sweep_inputs(key == "sweep_w", 1 if key == "sweep" else 2)
    js = _jax_sharded_sweep(inp)
    ours = [world[r][key] for r in range(2)]
    for name in ("feature", "cut"):
        for r in range(2):
            np.testing.assert_array_equal(np.asarray(getattr(js, name))[r],
                                          ours[r][name], err_msg=name)
    np.testing.assert_array_equal(
        np.concatenate([np.asarray(js.leaf_idx)[r] for r in range(2)], -1),
        np.concatenate([o["leaf_idx"] for o in ours], -1))
    for r in range(2):
        np.testing.assert_allclose(np.asarray(js.leaf_value)[r],
                                   ours[r]["leaf_value"], **TOL)
        for name in ("allfit", "tree_fit"):
            np.testing.assert_allclose(np.asarray(getattr(js, name))[r],
                                       ours[r][name], **TOL, err_msg=name)
    # the forests replicate over the data axis; moves were accepted
    np.testing.assert_array_equal(ours[0]["leaf_value"], ours[1]["leaf_value"])
    assert (ours[0]["feature"] != inp["feature"]).any()
    # one all-reduce per tree update
    assert ours[0]["reductions"] == ours[1]["reductions"] == T


def test_padding_with_a_weight_zero_replica_changes_no_statistic():
    """An odd n padded with a weight-0 copy of row 0 sweeps as the
    unpadded data: the same forests, fits within 1e-12 on the real rows."""
    inp = _sweep_inputs(False, 3)
    cfg = tb.BartConfig(**inp["cfg"])
    n = N - 1
    st = tb.BartState(
        feature=torch.as_tensor(inp["feature"]),
        cut=torch.as_tensor(inp["cut"]),
        leaf_value=torch.as_tensor(inp["leaf_value"]),
        leaf_idx=torch.as_tensor(inp["leaf_idx"][..., :n]),
        allfit=torch.as_tensor(inp["allfit"][..., :n]),
        k=torch.full((C,), 2.0, dtype=torch.float64),
        sigma_mu=torch.as_tensor(inp["sigma_mu"]),
        tree_fit=torch.as_tensor(inp["tree_fit"][..., :n]))
    pad = lambda a: torch.cat([a, a[..., :1]], -1)  # noqa: E731
    st_p = st._replace(leaf_idx=pad(st.leaf_idx), allfit=pad(st.allfit),
                       tree_fit=pad(st.tree_fit))
    y = torch.as_tensor(inp["y"][:n]).expand(C, n)
    ranks = torch.as_tensor(inp["ranks"][:n])
    var = (torch.as_tensor(inp["u"]), torch.as_tensor(inp["zn"]))
    sigma = torch.as_tensor(inp["sigma"])
    a, _ = tb.bart_sweep(cfg, st, y, ranks, inp["split_probs"], sigma,
                         variates=var, reduce=lambda x: x)
    w = torch.cat([torch.ones(n, dtype=torch.float64),
                   torch.zeros(1, dtype=torch.float64)])
    b, _ = tb.bart_sweep(cfg, st_p, pad(y), torch.cat([ranks, ranks[:1]]),
                         inp["split_probs"], sigma, weights=w, variates=var,
                         reduce=lambda x: x)
    for name in ("feature", "cut"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert torch.equal(a.leaf_idx, b.leaf_idx[..., :n])
    torch.testing.assert_close(a.leaf_value, b.leaf_value, rtol=1e-12,
                               atol=1e-12)
    torch.testing.assert_close(a.allfit, b.allfit[..., :n], rtol=1e-12,
                               atol=1e-12)


def _unsharded(n=60, binary=False, weights=False, chains=2, seed=43,
               stan_args=None, **kw):
    """The single-process fit of the one chain group's seed."""
    df = worker._df(n, binary)
    w = (np.random.default_rng(7).uniform(0.5, 2.0, n) if weights
         else None)
    return stan4bart_torch.stan4bart(
        worker.FORMULA, df, device="cpu", dtype=torch.float64,
        chains=chains, seed=multihost.rank_seed(seed, 0, 1), verbose=-1,
        weights=w, bart_args={"n.trees": 4}, stan_args=stan_args, **kw)


@pytest.mark.parametrize("case", list(FITS))
def test_obs_sharded_fit_matches_the_unsharded_fit(world, case):
    a, b = world[0][case], world[1][case]
    assert a["info"]["obs_shards"] == 2 and a["info"]["chain_groups"] == 1
    for name in a["draws"]:
        np.testing.assert_array_equal(a["draws"][name], b["draws"][name],
                                      err_msg=name)
    kw = {k: v for k, v in FIT3.items() if k != "stan_args"}
    ref = _unsharded(**FITS[case], **kw)
    assert a["draws"]["bart_train"].shape == ref.draws.bart_train.shape
    for name in ("stan", "bart_train", "bart_test", "k", "varcount"):
        np.testing.assert_allclose(a["draws"][name],
                                   getattr(ref.draws, name), **FIT_TOL,
                                   err_msg=f"{case}: {name}")


def test_obs_sharded_chunked_equals_whole(world):
    whole, chunked = world[0]["whole"]["draws"], world[0]["chunked"]["draws"]
    for name in whole:
        np.testing.assert_array_equal(whole[name], chunked[name],
                                      err_msg=name)
    assert whole["stan"].shape[:2] == (2, 10)


def test_obs_sharded_refusals_match_the_jax_package(world):
    msgs = world[0]["refusals"]
    assert msgs == world[1]["refusals"]
    assert "Gram" in msgs["no_gram"]
    assert "pooled_adaptation is not supported obs-sharded" in msgs["pooled"]
    for name in ("callback", "keep_fits"):
        assert "obs_shards does not compose with callback" in msgs[name]
    assert msgs["divide"] == ("obs_shards (3) must divide the global "
                              "device count (2)")


def test_obs_shards_outside_a_world_is_the_device_count_error():
    with pytest.raises(ValueError, match=r"obs_shards \(2\) must divide "
                       r"the global device count \(1\)"):
        _unsharded(iter=2, warmup=1, stan_args=OBS)


def test_local_view_refuses_what_the_jax_package_refuses():
    fit = _unsharded(iter=2, warmup=1, stan_args={"gram_lik": False})
    with pytest.raises(ValueError, match="Gram-compressed"):
        fit.prog.local_view({}, None, None, fit.prog.N, 0)


def test_one_reduction_per_tree_update():
    """A counting reduce hook sees one reduction per tree update (the
    counterpart of test_single_psum_per_tree_update), and one more per
    regrow."""
    inp = _sweep_inputs(False, 4)
    cfg = tb.BartConfig(**inp["cfg"])
    st = tb.BartState(
        *(torch.as_tensor(inp[k]) for k in
          ("feature", "cut", "leaf_value", "leaf_idx", "allfit")),
        k=torch.full((C,), 2.0, dtype=torch.float64),
        sigma_mu=torch.as_tensor(inp["sigma_mu"]),
        tree_fit=torch.as_tensor(inp["tree_fit"]))
    seen = []

    def count(x):
        seen.append(tuple(x.shape))
        return x

    args = (torch.as_tensor(inp["y"]).expand(C, N),
            torch.as_tensor(inp["ranks"]), inp["split_probs"],
            torch.as_tensor(inp["sigma"]))
    tb.bart_sweep(cfg, st, *args, reduce=count,
                  variates=(torch.as_tensor(inp["u"]),
                            torch.as_tensor(inp["zn"])))
    assert seen == [(C, 2, cfg.max_nodes + 1)] * T
    seen.clear()
    gen = torch.Generator()
    gen.manual_seed(0)
    tb.bart_sweep(cfg._replace(regrow_per_sweep=2), st, *args, gen,
                  reduce=count)
    assert seen == ([(C, 2, cfg.max_nodes + 1)] * T
                    + [(C, 4, cfg.max_nodes)] * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("weighted", [False, True])
def test_cuda_sharded_kernel_matches_the_plain_sharded_sweep(weighted):
    """csrc/bart_sweep_sharded.cu at one rank, the reduce hook a copy,
    against the plain sharded sweep on shared variates (float32: identical
    forests, leaf values and fits within float32 tolerance), at several
    stats-launch cluster sizes; weight-0 rows take the weighted path."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from stan4bart_torch.ops import bart_sweep_kernel as tk

    dev = torch.device("cuda")
    n, Pc, Tc, Cc = 12_345, 5, 20, 16
    rng = np.random.default_rng(6)
    X = rng.normal(size=(n, Pc))
    y = np.sin(X[:, 0]) + X[:, 1] ** 2 + rng.normal(scale=0.5, size=n)
    cfg = tb.BartConfig(num_trees=Tc)
    ranks = tb.compute_ranks(X, tb.make_cut_grid(X, cfg.n_cuts))
    sp = np.full(Pc, 1.0 / Pc)
    gen = torch.Generator(device=dev)
    gen.manual_seed(6)
    st = tb.sample_trees_from_prior(cfg, gen, torch.as_tensor(ranks,
                                                              device=dev),
                                    sp, Cc, dtype=torch.float32)
    consts = tk.make_sweep_consts(cfg, ranks, sp, device=dev)
    var = tb.draw_variates(gen, Cc, Tc, torch.float32, dev)
    w = None
    if weighted:
        w_np = rng.uniform(0.5, 2.0, n)
        w_np[-7:] = 0.0
        w = torch.as_tensor(w_np, dtype=torch.float32, device=dev)
    args = (cfg, st.feature, st.cut, st.leaf_idx, st.tree_fit,
            torch.as_tensor(y, dtype=torch.float32,
                            device=dev).expand(Cc, n).contiguous(),
            torch.full((Cc,), 0.81, device=dev), st.sigma_mu ** 2,
            var[0], var[1], consts)
    p = tk.sweep_plain(*args, weights=w, reduce=lambda x: x)
    for K in (1, 2, 4):
        k = tk.sweep_sharded_cuda(*args, weights=w, reduce=torch.clone,
                                  cluster=K)
        torch.cuda.synchronize()
        for i in (0, 1, 3):
            assert torch.equal(k[i], p[i]), (K, i)
        torch.testing.assert_close(k[2], p[2], rtol=2e-4, atol=2e-5)
        torch.testing.assert_close(k[4], p[4], rtol=5e-4, atol=5e-4)
        torch.testing.assert_close(k[5], p[5], rtol=5e-4, atol=5e-4)

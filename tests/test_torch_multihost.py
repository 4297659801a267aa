"""Multi-process chain execution in the port (parallel/multihost.py,
parallel/mesh.py), as tests/test_multihost.py holds the JAX package's.

Two gloo ranks on the CPU (``mesh.spawn``) fit the JAX worker's tiny
model (n = 60, 4 trees, 4 chains; 8 warmup of 16 iterations, the
contracts being identities) inside one world.  The port has one
generator per chain group, seeded by
``multihost.rank_seed``, so the contract is: both ranks hold the same
gathered draws, and rank r's block of chains is, to the bit, the
single-process fit of its 2 chains with its seed (both run on one CPU
thread, so every sum is taken in the same order).  Pooled adaptation over
the ranks gives the pooled metric of one process holding all 4 chains
(rtol 1e-12: the sums over chains are grouped by rank), and a rank that
raises makes ``spawn`` raise at once rather than hang."""

import time

import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.ops.nuts import WelfordState, pooled_welford_variance
from stan4bart_torch.parallel import _mh_worker as worker
from stan4bart_torch.parallel import mesh, multihost
from stan4bart_torch.parallel.diagnostics import ess, split_rhat

KW = dict(chains=4, warmup=8, iter=16, seed=42, verbose=-1,
          bart_args={"n.trees": 4})
# a warmup of 20 has one metric window, ending at iteration 17
POOLED = dict(KW, iter=30, warmup=20,
              stan_args={"pooled_adaptation": True, "pooled_parts": "both"})


def _welford(seed=0, C=4, D=5):
    rng = np.random.default_rng(seed)
    return (np.full(C, 12.0), rng.normal(size=(C, D)),
            rng.uniform(0.5, 3.0, size=(C, D)) * 11.0)


@pytest.fixture(scope="module")
def world():
    count, mean, m2 = _welford()
    cases = [("fit_case", dict(key="chain", diagnostics=True,
                               warmup=KW["warmup"], iter=KW["iter"])),
             ("fit_case", dict(POOLED, key="pooled")),
             ("pooled_metric_case", dict(key="metric", count=count,
                                         mean=mean, m2=m2)),
             ("pooled_metric_case", dict(key="metric_between", count=count,
                                         mean=mean, m2=m2, between=True))]
    return mesh.spawn(worker.run_cases, ["cpu", "cpu"], "gloo",
                      args=(cases,), timeout_s=120)


def _single(seed, **kw):
    """A single-process fit on one CPU thread, as a spawned rank runs."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        args = dict(KW, **kw)
        args["seed"] = seed
        return stan4bart_torch.stan4bart(
            worker.FORMULA, worker._df(), device="cpu",
            dtype=torch.float64, **args)
    finally:
        torch.set_num_threads(threads)


def test_both_ranks_hold_the_same_gathered_draws(world):
    a, b = world[0]["chain"], world[1]["chain"]
    assert a["info"] == dict(b["info"], rank=0)
    assert a["info"]["world_size"] == 2 and a["info"]["chain_groups"] == 2
    for name in a["draws"]:
        np.testing.assert_array_equal(a["draws"][name], b["draws"][name],
                                      err_msg=name)
    assert a["draws"]["stan"].shape[:2] == (4, KW["iter"])
    assert np.all(np.isfinite(a["draws"]["stan"]))


@pytest.mark.parametrize("rank", [0, 1])
def test_each_ranks_chains_equal_a_single_process_fit(world, rank):
    draws = world[0]["chain"]["draws"]
    ref = _single(multihost.rank_seed(42, rank, 2), chains=2)
    for name in draws:
        np.testing.assert_array_equal(
            draws[name][2 * rank: 2 * rank + 2], getattr(ref.draws, name),
            err_msg=name)


def test_sharded_diagnostics_equal_the_gathered_ones(world):
    res = world[0]["chain"]
    stan = res["draws"]["stan"][:, KW["warmup"]:]
    fit = _single(42, chains=2, iter=2, warmup=1)
    idx = [fit.stan_names.index("aux.1"), fit.stan_names.index("lp__")]
    sel = stan[..., idx]
    for r in range(2):
        d = world[r]["chain"]["diag"]
        np.testing.assert_allclose(d["rhat"], split_rhat(sel), rtol=1e-12)
        np.testing.assert_allclose(
            d["ess"], [ess(sel[..., j]) for j in range(2)], rtol=1e-12)
    # outside a world the function takes the whole draws
    d = multihost.sharded_diagnostics(stan, idx)
    np.testing.assert_allclose(d["rhat"], split_rhat(sel), rtol=1e-12)


@pytest.mark.parametrize("between", [False, True])
def test_pooled_metric_over_ranks_equals_the_single_process_pool(world,
                                                                 between):
    count, mean, m2 = _welford()
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    ref = pooled_welford_variance(WelfordState(t(count), t(mean), t(m2)),
                                  between).numpy()
    key = "metric_between" if between else "metric"
    for r in range(2):
        np.testing.assert_allclose(world[r][key], ref[2 * r: 2 * r + 2],
                                   rtol=1e-12, atol=0.0)


def test_pooled_adaptation_pools_over_every_rank(world):
    """pooled_parts="both": from the metric window's end on, every chain
    of both ranks adapts one stepsize from the pooled acceptance, so all
    four sample at one stepsize."""
    draws = world[0]["pooled"]["draws"]["stan"]
    step = draws[:, POOLED["warmup"]:, 2]          # stepsize__
    assert np.all(np.isfinite(draws))
    np.testing.assert_array_equal(step, np.broadcast_to(step[:1], step.shape))
    np.testing.assert_array_equal(draws, world[1]["pooled"]["draws"]["stan"])


def test_a_rank_that_raises_makes_spawn_raise():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 raised"):
        mesh.spawn(worker.fail_case, ["cpu", "cpu"], "gloo", timeout_s=120)
    assert time.monotonic() - t0 < 60


def test_fit_on_devices_returns_rank_zeros_fit(world):
    """The ``cores`` path over several devices: one spawned rank per
    device, rank 0's fit loaded back, equal to the world's draws."""
    fit = mesh.fit_on_devices(["cpu", "cpu"], "gloo", worker.FORMULA,
                              worker._df(), dict(KW, dtype=torch.float64))
    draws = world[0]["chain"]["draws"]
    for name in draws:
        np.testing.assert_array_equal(getattr(fit.draws, name), draws[name],
                                      err_msg=name)
    assert fit.run_info["world_size"] == 2 and fit.final_states is None
    assert fit.timings["gather"] >= 0.0
    assert fit.prog.device.type == "cpu"

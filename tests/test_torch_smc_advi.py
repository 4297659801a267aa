"""The port's standalone samplers: tempered SMC (``ops/smc.py``), ADVI
(``ops/advi.py``) and the NUTS driver (``ops/nuts_driver.py``).

Known-posterior recovery with the JAX package's tolerances
(tests/test_smc.py, tests/test_advi.py:30-58, tests/test_nuts.py), and
exact agreement with the JAX package's functions where their randomness
can be shared: the SMC weight helpers, one tempering bisection on the
same particles, and a block of ADVI iterations on the reference's
normals (1e-9 relative).  Float64 on the CPU."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stan4bart_torch.ops import advi as tadvi
from stan4bart_torch.ops import smc as tsmc
from stan4bart_torch.ops.nuts import NutsConfig
from stan4bart_torch.ops.nuts_driver import nuts_sample
from stan4bart_tpu.ops import advi as jadvi
from stan4bart_tpu.ops import smc as jsmc

torch.set_num_threads(2)
f64 = torch.float64


def _gen(seed):
    g = torch.Generator()
    g.manual_seed(seed)
    return g


# -- SMC ----------------------------------------------------------------------

def test_smc_gaussian_target():
    mean = torch.tensor([1.0, -2.0, 0.5], dtype=f64)
    sd = torch.tensor([0.5, 2.0, 1.0], dtype=f64)

    def logp(q):
        return -0.5 * (((q - mean) / sd) ** 2).sum(-1)

    res = tsmc.smc_sample(logp, 3, 2048, _gen(0), device="cpu")
    assert float(res.final_temp) == 1.0
    u = res.particles.numpy()
    assert np.allclose(u.mean(axis=0), mean.numpy(), atol=0.15)
    assert np.allclose(u.std(axis=0), sd.numpy(), rtol=0.2)


def test_smc_evidence_estimate():
    s, d = 2.0, 2

    def logp(q):
        return -0.5 * (q * q).sum(-1) / s ** 2

    res = tsmc.smc_sample(logp, d, 4096, _gen(1), device="cpu")
    logZ_true = 0.5 * d * np.log(2 * np.pi * s ** 2) - 0.5 * d * np.log(
        2 * np.pi)
    assert abs(float(res.log_evidence) - logZ_true) < 0.25


def test_smc_helpers_and_one_stage_match_reference():
    """The ESS of log-weights, systematic resampling on the same uniform,
    and the first stage's bisected temperature and evidence increment on
    the reference's initial particles, equal to the JAX package's."""
    n, P = 512, 3
    mean = np.array([1.0, -2.0, 0.5])

    def logp_j(q):
        return -0.5 * jnp.sum((q - mean) ** 2) * 4.0

    def logp_t(q):
        return -0.5 * ((q - torch.as_tensor(mean)) ** 2).sum(-1) * 4.0

    logw = np.random.default_rng(0).normal(0.0, 3.0, n)
    np.testing.assert_allclose(
        float(tsmc._ess_from_logw(torch.as_tensor(logw))),
        float(jsmc._ess_from_logw(jnp.asarray(logw))), rtol=1e-12)
    key = jax.random.PRNGKey(4)
    u0 = float(jax.random.uniform(key))
    np.testing.assert_array_equal(
        tsmc._systematic_resample(None, torch.as_tensor(logw), n,
                                  u=torch.tensor(u0, dtype=f64)).numpy(),
        np.asarray(jsmc._systematic_resample(key, jnp.asarray(logw), n)))

    # one stage of the reference: its temperature and evidence increment
    key = jax.random.PRNGKey(5)
    ref = jsmc.smc_sample(logp_j, P, n, key, max_stages=1)
    _, k_init = jax.random.split(key)
    u = torch.as_tensor(np.array(jax.random.normal(k_init, (n, P),
                                                   jnp.float64)))
    ll = logp_t(u) - tsmc._log_base(u)
    t0 = torch.zeros((), dtype=f64)
    t1 = tsmc._next_temp(ll, t0, 0.5 * n, 26)
    assert 0.0 < float(t1) < 1.0
    assert float(t1) == float(ref.final_temp)
    log_z = torch.logsumexp((t1 - t0) * ll, 0) - np.log(n)
    np.testing.assert_allclose(float(log_z), float(ref.log_evidence),
                               rtol=1e-12)


# -- ADVI ---------------------------------------------------------------------

def _conjugate_problem(seed=0, n=300, k=3):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, k))
    w = rng.normal(size=k)
    s2, t2 = 0.7 ** 2, 3.0 ** 2
    y = X @ w + rng.normal(0, np.sqrt(s2), n)
    prec = X.T @ X / s2 + np.eye(k) / t2
    cov = np.linalg.inv(prec)
    mean = cov @ (X.T @ y / s2)
    Xt, yt = torch.as_tensor(X), torch.as_tensor(y)

    def logp(q):
        r = yt - q @ Xt.T
        return -0.5 * (r * r).sum(-1) / s2 - 0.5 * (q * q).sum(-1) / t2

    Xj, yj = jnp.asarray(X), jnp.asarray(y)

    def logp_j(q):
        r = yj - Xj @ q
        return -0.5 * jnp.sum(r * r) / s2 - 0.5 * jnp.sum(q * q) / t2

    return logp, logp_j, mean, cov, k


@functools.partial(jax.jit, static_argnums=(1, 2, 3))
def _normal_block(key, n, n_mc, P):
    """normal(fold_in(key, i), (n_mc, P)) for i < n: one block of the JAX
    package's ADVI iterations."""
    return jax.vmap(lambda i: jax.random.normal(
        jax.random.fold_in(key, i), (n_mc, P), jnp.float64))(jnp.arange(n))


def _ref_normals(key, n_mc, P, eta_grid=(100.0, 10.0, 1.0, 0.1, 0.01),
                 eta_adapt_iters=40, eval_every=50):
    """The JAX package's ``advi`` normals in the order its iterations run:
    each eta-grid run's, then the main run's blocks (its key splits and
    folds)."""
    def block(k, n):
        return [torch.as_tensor(z) for z in np.array(_normal_block(
            k, n, n_mc, P))]

    for _ in eta_grid:
        key, k_try = jax.random.split(key)
        yield from block(k_try, eta_adapt_iters)
    key, k_main = jax.random.split(key)
    while True:
        k_main, k_b = jax.random.split(k_main)
        yield from block(k_b, eval_every)


def _advi_both(seed, family, **kw):
    """The port's ADVI on the JAX package's normals and the JAX package's
    own run: the same eta, iterations and variational parameters."""
    logp, logp_j, mean, cov, k = _conjugate_problem(seed)
    key = jax.random.PRNGKey(seed)
    n_mc = kw.get("n_mc", 10)
    mu, omega, info = tadvi.advi(logp, k, None, family=family,
                                 normals=_ref_normals(key, n_mc, k),
                                 device="cpu", **kw)
    r_mu, r_omega, r_info = jadvi.advi(logp_j, k, key, family=family, **kw)
    assert (info["eta"], info["iters"]) == (r_info["eta"], r_info["iters"])
    np.testing.assert_allclose(mu.numpy(), np.asarray(r_mu), rtol=1e-7,
                               atol=1e-9)
    np.testing.assert_allclose(omega.numpy(), np.asarray(r_omega),
                               rtol=1e-7, atol=1e-9)
    return mu.numpy(), omega.numpy(), mean, cov


def test_advi_meanfield_recovers_mean():
    mu, omega, mean, cov = _advi_both(0, "meanfield", max_iters=3000)
    assert np.allclose(mu, mean, atol=0.05)
    ratio = np.exp(omega) / np.sqrt(np.diag(cov))
    assert np.all(ratio > 0.4) and np.all(ratio < 2.0)


def test_advi_fullrank_recovers_covariance():
    mu, L, mean, cov = _advi_both(1, "fullrank", max_iters=4000, n_mc=20)
    assert np.allclose(mu, mean, atol=0.08)
    assert np.allclose(L @ L.T, cov, atol=0.3 * np.abs(cov).max() + 0.02)


def test_advi_draws_from_q():
    """The port's own generator end to end: ADVI, then draws from q."""
    logp, _, mean, cov, k = _conjugate_problem(seed=2)
    mu, omega, _ = tadvi.advi(logp, k, _gen(2), max_iters=2000,
                              device="cpu")
    draws = tadvi.advi_draws(mu, omega, _gen(3), 4000).numpy()
    assert draws.shape == (4000, k)
    assert np.allclose(draws.mean(axis=0), mu.numpy(), atol=0.1)


@pytest.mark.parametrize("fullrank,it0", [(False, 0.0), (False, 50.0),
                                          (True, 0.0)],
                         ids=["meanfield", "meanfield-it50", "fullrank"])
def test_advi_block_matches_reference(fullrank, it0):
    logp, logp_j, _, _, P = _conjugate_problem(seed=3)
    n_mc, n_iters, eta = 5, 12, 0.1
    rng = np.random.default_rng(7)
    omega0 = (np.eye(P) + 0.1 * np.tril(rng.normal(size=(P, P)), -1)
              if fullrank else rng.uniform(-1.0, 0.0, P))
    v0 = np.concatenate([rng.normal(size=P), omega0.reshape(-1)])
    acc0 = rng.uniform(0.5, 2.0, v0.size) if it0 else np.zeros(v0.size)

    def neg_elbo(v, key):
        mu = v[:P]
        omega = v[P:].reshape(P, P) if fullrank else v[P:]
        return -jadvi.elbo(logp_j, mu, omega, key, n_mc, fullrank)

    key = jax.random.PRNGKey(8)
    ref = jax.jit(lambda v, acc: jadvi._advi_block(
        jax.value_and_grad(neg_elbo), v, acc, key, eta, 1.0, n_iters,
        fullrank, P, it0))(jnp.asarray(v0), jnp.asarray(acc0))
    z = np.stack([np.asarray(jax.random.normal(
        jax.random.fold_in(key, i), (n_mc, P), jnp.float64))
        for i in range(n_iters)])
    grad_fn = tadvi._elbo_grad_fn(logp, P, n_mc, fullrank, None)
    port = tadvi._advi_block(grad_fn, torch.as_tensor(v0),
                             torch.as_tensor(acc0), eta, 1.0, n_iters,
                             fullrank, P, it0, z=torch.as_tensor(z))
    for name, a, b in zip(("v", "acc", "mean loss"), port, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-12, err_msg=name)


# -- the NUTS driver ----------------------------------------------------------

def test_nuts_sample_scaled_normal():
    """tests/test_nuts.py's gates (accept statistic near adapt_delta, no
    divergences, the marginal sds within 15 %, the adapted metric within
    3x the variances) on its scaled normal, from a batch of one; 250
    warmup and 300 sampling iterations (the reference's test runs 800 and
    2000), to keep the file's time."""
    scales = torch.tensor([0.1, 1.0, 10.0], dtype=f64)

    def logp(q):
        return -0.5 * ((q / scales) ** 2).sum(-1)

    qs, info, state = nuts_sample(logp, torch.zeros(3, dtype=f64), _gen(1),
                                  num_warmup=250, num_samples=300,
                                  cfg=NutsConfig(max_treedepth=6),
                                  device="cpu")
    assert qs.shape == (300, 3)
    assert all(x.shape == (300,) for x in info)
    assert state.q.shape == state.inv_mass.shape == (3,)
    assert info.divergent.sum() == 0
    assert float(info.treedepth.max()) <= 6
    assert 0.6 < float(info.accept_stat.mean()) < 1.0
    assert np.allclose(qs.std(0).numpy(), scales.numpy(), rtol=0.15)
    ratio = (state.inv_mass / scales ** 2).numpy()
    assert np.all(ratio > 0.3) and np.all(ratio < 3.0)

"""The port's coefficient prior families and the lkj covariance prior
against the JAX package's, in float64.

Each family's model is built by both packages from the same model frame;
the log-density and its gradient, the constrained draw, the names and
the initial inverse metric must agree within 1e-9 relative (the same
arithmetic, sums taken in another order).  The validation errors of
tests/test_prior_families.py are held on the port's entry point, and a
tiny CPU fit per family must be finite."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.formula import build_model_frame as port_mf
from stan4bart_torch.models import priors as pp
from stan4bart_torch.models.assemble import build_parametric_model as port_pm
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.models import priors as rp
from stan4bart_tpu.models.assemble import build_parametric_model as ref_pm
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")
C = 3
TOL = dict(rtol=1e-9, atol=1e-9)

# (id, prior spec of a priors module, extra stan_args)
FAMILIES = [
    ("normal", lambda m: m.normal(0, 2.5, autoscale=True), {}),
    ("student_t", lambda m: m.student_t(df=4, scale=2.5, autoscale=True),
     {}),
    ("cauchy", lambda m: m.cauchy(scale=2.5), {}),
    ("hs", lambda m: m.hs(), {}),
    ("hs_plus", lambda m: m.hs_plus(df1=2.0, df2=3.0), {}),
    ("laplace", lambda m: m.laplace(scale=2.5, autoscale=True), {}),
    ("lasso", lambda m: m.lasso(df=2.0, scale=2.5), {}),
    ("product_normal", lambda m: m.product_normal(df=2, scale=1.5), {}),
    ("R2", lambda m: m.R2(0.5, "mean"), {"qr": True}),
    ("flat", lambda m: None, {}),
]


@pytest.fixture(scope="module")
def frames():
    d = generate_friedman_data(120, ranef=True, causal=True)
    df = friedman_dataframe(d)
    rng = np.random.default_rng(0)
    off = d["mu_bart"][None] + rng.normal(scale=0.5, size=(C, 120))
    return d, df, ref_mf(FLAGSHIP, df), port_mf(FLAGSHIP, df), off


def _hold(rpm, ppm, rmf, off, seed=1):
    """log_prob, gradient, constrained draw, names and initial metric of
    the two models at the same unconstrained points."""
    assert rpm.layout.slices == ppm.layout.slices
    assert rpm.constrained_names() == ppm.constrained_names()
    y = np.asarray(rmf.y)
    U = np.random.default_rng(seed).uniform(-1, 1, size=(C, rpm.num_upars))
    ref_lp, ref_g = jax.jit(jax.vmap(jax.value_and_grad(
        lambda u, o: rpm.log_prob(u, o, jnp.asarray(y)))))(
            jnp.asarray(U), jnp.asarray(off))
    u = torch.tensor(U, requires_grad=True)
    lp = ppm.log_prob(u, torch.as_tensor(off), torch.as_tensor(y))
    (g,) = torch.autograd.grad(lp.sum(), u)
    np.testing.assert_allclose(np.asarray(ref_lp), lp.detach().numpy(),
                               **TOL)
    np.testing.assert_allclose(np.asarray(ref_g), g.numpy(), **TOL)
    ref_draw = np.asarray(jax.jit(jax.vmap(rpm.constrained_draw))(
        jnp.asarray(U)))
    np.testing.assert_allclose(
        ref_draw, ppm.constrained_draw(torch.as_tensor(U)).numpy(), **TOL)
    np.testing.assert_allclose(np.asarray(rpm.initial_inv_mass(1.7, 120)),
                               ppm.initial_inv_mass(1.7, 120), **TOL)
    return U


@pytest.mark.parametrize("fid,spec,extra", FAMILIES,
                         ids=[f[0] for f in FAMILIES])
def test_coef_prior_family_matches(frames, fid, spec, extra):
    d, df, rmf, pmf, off = frames
    r, _, rinfo = ref_pm(rmf, "gaussian", {"prior": spec(rp), **extra})
    p, _, pinfo = port_pm(pmf, "gaussian", {"prior": spec(pp), **extra},
                          device="cpu")
    assert p.cfg.prior_dist == r.cfg.prior_dist
    assert p.cfg.z_beta_dim == r.cfg.z_beta_dim
    if extra.get("qr"):
        np.testing.assert_allclose(rinfo["R_inv"], pinfo["R_inv"], **TOL)
    U = _hold(r, p, rmf, off)
    # prior draws: generative for normal / t / product-normal / R2, and
    # the reference's raises elsewhere
    if p.cfg.prior_dist in (1, 2, 7, 8):
        draws = p.prior_draw_unconstrained(np.random.default_rng(0), 32)
        assert draws.shape == (32, p.num_upars)
        assert torch.isfinite(p.log_prob(
            draws, torch.as_tensor(off[:1]),
            torch.as_tensor(np.asarray(pmf.y)))).all()
    else:
        with pytest.raises(NotImplementedError, match="prior_draw"):
            p.prior_draw_unconstrained(np.random.default_rng(0))
    assert U.shape[1] == p.num_upars


def test_lkj_prior_covariance_matches(frames):
    """lkj() as prior_covariance: half-t sds and the LKJ onion in place
    of decov's zeta and tau."""
    d, df, rmf, pmf, off = frames
    args = lambda m: {"prior_covariance": m.lkj(  # noqa: E731
        regularization=2.0, scale=5.0, df=3.0)}
    r, _, _ = ref_pm(rmf, "gaussian", args(rp))
    p, _, _ = port_pm(pmf, "gaussian", args(pp), device="cpu")
    assert p.cfg.cov_prior == 1
    assert "sds.1" in p.constrained_names()
    assert "tau.1" not in p.constrained_names()
    _hold(r, p, rmf, off, seed=2)
    np.testing.assert_allclose(p.hyper_np["lkj_scale"],
                               r.hyper["lkj_scale"], **TOL)
    draws = p.prior_draw_unconstrained(np.random.default_rng(3), 16)
    assert torch.isfinite(draws).all()


def test_R2_validation():
    with pytest.raises(ValueError, match="negative"):
        pp.R2(0.5, "log")
    with pytest.raises(ValueError, match="mode"):
        pp.R2(1.5, "mode")
    with pytest.raises(ValueError, match="single numeric"):
        pp.R2(None)
    with pytest.raises(ValueError, match="fewer than three"):
        pp.make_eta(0.5, "mode", 2)
    for loc, what in ((0.5, "mean"), (0.5, "mode"), (0.5, "median"),
                      (-1.0, "log")):
        assert pp.make_eta(loc, what, 4) == pytest.approx(
            rp.make_eta(loc, what, 4), rel=1e-12)


def test_prior_errors_on_the_entry_point(frames):
    d, df, rmf, pmf, off = frames
    kw = dict(chains=1, iter=4, verbose=-1, device="cpu")
    with pytest.raises(ValueError, match="qr"):
        stan4bart_torch.stan4bart("y ~ bart(X1 + X2) + X4 + z", df,
                                  stan_args={"prior": pp.R2(0.5, "mean")},
                                  **kw)
    with pytest.raises(ValueError, match="gaussian"):
        port_pm(port_mf("y ~ bart(X1 + X2) + X4 + z", dict(
            df, y=(np.asarray(df["y"]) > 0).astype(float))), "binomial",
            {"prior": pp.R2(0.5, "mean"), "qr": True}, device="cpu")
    d0 = pp.dirichlet(concentration=2.0)
    assert d0 == {"dist": "dirichlet", "concentration": 2.0}
    with pytest.raises(ValueError, match="positive"):
        pp.dirichlet(-1.0)
    with pytest.raises(ValueError, match="covariance-simplex"):
        stan4bart_torch.stan4bart("y ~ bart(X1 + X2) + X4", df,
                                  stan_args={"prior": d0}, **kw)
    with pytest.raises(ValueError, match="prior_covariance"):
        stan4bart_torch.stan4bart(
            "y ~ bart(X1 + X2) + X4 + (1 | g.1)", df,
            stan_args={"prior_covariance": pp.normal()}, **kw)
    for bad in (lambda: pp.normal(0, -1.0), lambda: pp.student_t(df=-2),
                lambda: pp.decov(shape=0.0), lambda: pp.lkj(scale=-1.0)):
        with pytest.raises(ValueError, match="positive"):
            bad()


@pytest.mark.parametrize("fid", ["hs", "hs_plus", "laplace", "lasso",
                                 "product_normal", "R2", "lkj"])
def test_tiny_fit_per_prior(frames, fid):
    """A tiny CPU fit per family through the entry point: finite draws;
    the shrinkage families switch the conjugate linear refresh off."""
    d, df, rmf, pmf, off = frames
    spec = {f[0]: f for f in FAMILIES}
    if fid == "lkj":
        sa = {"prior_covariance": pp.lkj()}
    else:
        sa = {"prior": spec[fid][1](pp), **spec[fid][2]}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        fit = stan4bart_torch.stan4bart(
            FLAGSHIP, df, chains=2,
            iter=12, warmup=6, seed=4, verbose=-1, device="cpu",
            bart_args={"n.trees": 5},
            stan_args={"max_treedepth": 4, **sa})
    assert np.all(np.isfinite(fit.draws.stan))
    assert np.all(np.isfinite(fit.extract("fixef")))
    assert fit.prog.linear_gibbs == (fid == "lkj")

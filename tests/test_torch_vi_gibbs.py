"""The port's VI-within-Gibbs update against the JAX package's, in
float64, and the VI knobs' validation.

``GibbsProgram._vi_update`` (the ``algorithm="vi"`` / ``"advi"`` step of
the parametric block) takes the reference's normals, replayed from its
key folds (``fold_in(key, 101 + j)`` for step j's ELBO draws,
``fold_in(key, 7)`` for the draw from q), and must give the same
variational state, draw and log-density within 1e-9 relative: rmsprop
meanfield, adagrad meanfield and adagrad fullrank, each from a fresh
state (count 0) and a warm one (count > 0).  The state is a JAX state
carried over by ``convert.state_from_numpy``, its ``vi`` field included;
both log-densities are the Gram-anchored ones of the main path.  A tiny
model: n = 60, one varying slope, 2 chains."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.convert import state_from_numpy
from stan4bart_torch.formula import build_model_frame as port_mf
from stan4bart_torch.gibbs import GibbsProgram as PortProgram
from stan4bart_torch.models.assemble import StanArgs as PortStanArgs
from stan4bart_torch.models.assemble import _validate_stan_args as port_check
from stan4bart_torch.models.assemble import build_parametric_model as port_pm
from stan4bart_torch.ops.bart import BartConfig as PortBartConfig
from stan4bart_torch.ops.bart import sample_trees_from_prior
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.gibbs import GibbsProgram as RefProgram
from stan4bart_tpu.gibbs import GibbsState as RefState
from stan4bart_tpu.gibbs import ViState as RefVi
from stan4bart_tpu.models.assemble import StanArgs as RefStanArgs
from stan4bart_tpu.models.assemble import _validate_stan_args as ref_check
from stan4bart_tpu.models.assemble import build_parametric_model as ref_pm
from stan4bart_tpu.ops import bart as jb
from stan4bart_tpu.ops.nuts import nuts_init
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1 + X2) + X4 + (1 + X4 | g.1)"
N, T, C = 60, 4, 2
TOL = dict(rtol=1e-9, atol=1e-10)
VI_CASES = [("rmsprop", "meanfield"), ("adagrad", "meanfield"),
            ("adagrad", "fullrank")]


@functools.cache
def _programs(vi_method, vi_family):
    d = generate_friedman_data(N, ranef=True)
    df = friedman_dataframe(d)
    rmf, pmf = ref_mf(FORMULA, df), port_mf(FORMULA, df)
    rpm, _, _ = ref_pm(rmf, "gaussian")
    ppm, _, _ = port_pm(pmf, "gaussian", device="cpu")
    kw = dict(warmup=5, iterations=5, parametric_method="vi",
              vi_method=vi_method, vi_family=vi_family, vi_steps=3,
              vi_mc=4, vi_eta=0.5)
    rprog = RefProgram(rpm, jb.BartConfig(num_trees=T), rmf.y, rmf.bart_X,
                       **kw)
    pprog = PortProgram(ppm, PortBartConfig(num_trees=T), pmf.y, pmf.bart_X,
                        dtype=torch.float64, device="cpu", **kw)
    assert rprog.use_gram and pprog.use_gram
    rpm = rprog.pm

    def ref_one(st, key):
        anchor = rpm.gram_anchor(st.nuts.q, st.stan_offset, rprog.y)
        return rprog._vi_update(
            st, lambda u: rpm.log_prob_gram(u, anchor), key)

    # the reference's update of every chain, compiled once per case
    return jax.jit(jax.vmap(ref_one)), pprog


def _ref_state(pprog, fullrank, warm):
    """A JAX GibbsState (chain-stacked) with a prior forest, a random
    Stan offset, parametric positions near 0 and a VI state: the init's
    (count 0, acc 0) or a warm one (count 7, positive acc, off-diagonal
    factor entries)."""
    rng = np.random.default_rng(5 + warm + 2 * fullrank)
    P = pprog.pm.num_upars
    gen = torch.Generator()
    gen.manual_seed(3)
    forest = sample_trees_from_prior(pprog.bart_cfg, gen, pprog.ranks,
                                     pprog.split_probs, C)
    q = 0.3 * rng.standard_normal((C, P))
    nuts = jax.vmap(lambda q0: nuts_init(None, q0))(jnp.asarray(q))
    n_acc = 2 * P + (P * P if fullrank else 0)
    vi = RefVi(
        mu=jnp.asarray(q + 0.05 * rng.standard_normal((C, P))),
        omega=jnp.asarray(rng.uniform(-1.5, -0.2, (C, P))),
        acc=jnp.asarray(rng.uniform(0.1, 4.0, (C, n_acc)) if warm
                        else np.zeros((C, n_acc))),
        count=jnp.asarray(np.full(C, 7.0 if warm else 0.0)),
        L_off=jnp.asarray(0.1 * rng.standard_normal((C, P, P)) if fullrank
                          else np.zeros((C, 0, 0))))
    zeros = jnp.zeros((C, pprog.N))
    return RefState(
        nuts=nuts, bart=jb.BartState(*(jnp.asarray(x.numpy())
                                       for x in forest)),
        bart_offset=zeros, stan_offset=jnp.asarray(
            rng.normal(0.0, 2.0, (C, pprog.N))),
        latents=zeros, rng=jax.random.split(jax.random.PRNGKey(0), C),
        vi=vi)


@pytest.mark.parametrize("warm", [False, True], ids=["count0", "warm"])
@pytest.mark.parametrize("vi_method,vi_family", VI_CASES,
                         ids=["rmsprop", "adagrad", "adagrad-fullrank"])
def test_vi_update_matches_reference_on_replayed_normals(vi_method,
                                                         vi_family, warm):
    ref_update, pprog = _programs(vi_method, vi_family)
    fullrank = vi_family == "fullrank"
    ref_state = _ref_state(pprog, fullrank, warm)
    keys = jax.random.split(jax.random.PRNGKey(17), C)
    P, S, M = pprog.pm.num_upars, pprog.vi_steps, pprog.vi_mc
    r_nuts, r_info, r_vi = ref_update(ref_state, keys)
    # the reference's normals: step j's ELBO draws, then the draw from q
    z = np.stack([np.array(jax.vmap(lambda k: jax.random.normal(
        jax.random.fold_in(k, 101 + j), (M, P), jnp.float64))(keys))
        for j in range(S)])
    z_draw = np.array(jax.vmap(lambda k: jax.random.normal(
        jax.random.fold_in(k, 7), (1, P), jnp.float64))(keys))[:, 0]

    state = state_from_numpy(ref_state, device="cpu")
    assert state.vi.L_off.shape == ((C, P, P) if fullrank else (C, 0, 0))
    nuts, info, vi = pprog._vi_update(state, pprog.y, None,
                                      z=torch.as_tensor(z),
                                      z_draw=torch.as_tensor(z_draw))
    for name in ("mu", "omega", "acc", "count", "L_off"):
        np.testing.assert_allclose(getattr(vi, name).numpy(),
                                   np.asarray(getattr(r_vi, name)), **TOL,
                                   err_msg=name)
    np.testing.assert_allclose(nuts.q.numpy(), np.asarray(r_nuts.q), **TOL)
    for name in info._fields:
        np.testing.assert_allclose(getattr(info, name).numpy(),
                                   np.asarray(getattr(r_info, name)), **TOL,
                                   err_msg=name)
    np.testing.assert_array_equal(vi.count.numpy(),
                                  np.asarray(ref_state.vi.count) + S)


def test_init_state_vi_fields():
    """gibbs.py:567-583 of the JAX package: q starts at the chain's start
    with the initial metric's sds; acc of length 2P (+ P * P fullrank)
    and count 0; NUTS keeps zero-width fields."""
    _, pprog = _programs("adagrad", "fullrank")
    pm, P = pprog.pm, pprog.pm.num_upars
    d = generate_friedman_data(N, ranef=True)
    rpm, _, _ = ref_pm(ref_mf(FORMULA, friedman_dataframe(d)), "gaussian")
    scale_y = np.std(np.asarray(d["y"]), ddof=1)
    gen = torch.Generator()
    gen.manual_seed(1)
    st = pprog.init_state(gen, C)
    np.testing.assert_array_equal(st.vi.mu.numpy(), st.nuts.q.numpy())
    np.testing.assert_allclose(
        st.vi.omega.numpy(),
        np.broadcast_to(0.5 * np.log(rpm.initial_inv_mass(scale_y, N)),
                        (C, P)), rtol=1e-12)
    assert st.vi.acc.shape == (C, 2 * P + P * P) and not st.vi.acc.any()
    assert st.vi.L_off.shape == (C, P, P) and not st.vi.L_off.any()
    assert not st.vi.count.any()
    nuts_prog = PortProgram(pm, pprog.bart_cfg, np.asarray(d["y"]),
                            port_mf(FORMULA, friedman_dataframe(d)).bart_X,
                            warmup=5, iterations=5, dtype=torch.float64,
                            device="cpu")
    st = nuts_prog.init_state(gen, C)
    assert [tuple(x.shape) for x in st.vi] == [(C, 0), (C, 0), (C, 0), (C,),
                                               (C, 0, 0)]


@pytest.mark.parametrize("args", [
    {"vi_steps": 0}, {"vi_mc": 0}, {"vi_eta": 0.0}, {"vi_family": "dense"},
], ids=["vi_steps", "vi_mc", "vi_eta", "vi_family"])
def test_vi_knob_errors_match_reference(args):
    with pytest.raises(ValueError) as ref:
        ref_check(RefStanArgs(**args))
    with pytest.raises(ValueError) as port:
        port_check(PortStanArgs(**args))
    assert str(port.value) == str(ref.value)
    # also under the default algorithm, through the entry point
    df = friedman_dataframe(generate_friedman_data(N, ranef=True))
    with pytest.raises(ValueError, match=str(ref.value)):
        stan4bart_torch.stan4bart(FORMULA, df, iter=4, stan_args=args,
                                  device="cpu")


@pytest.mark.parametrize("kw", [
    {"parametric_method": "laplace"}, {"vi_method": "adam"},
    {"vi_family": "dense"}])
def test_program_vi_arguments_match_reference(kw):
    d = generate_friedman_data(N, ranef=True)
    df = friedman_dataframe(d)
    rmf, pmf = ref_mf(FORMULA, df), port_mf(FORMULA, df)
    rpm, _, _ = ref_pm(rmf, "gaussian")
    ppm, _, _ = port_pm(pmf, "gaussian", device="cpu")
    with pytest.raises(ValueError) as ref:
        RefProgram(rpm, jb.BartConfig(num_trees=T), rmf.y, rmf.bart_X, **kw)
    with pytest.raises(ValueError) as port:
        PortProgram(ppm, PortBartConfig(num_trees=T), pmf.y, pmf.bart_X,
                    device="cpu", **kw)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("u_rho,singular", [(-20.0, False), (-89.0, False),
                                            (-250.0, True)],
                         ids=["rounded", "probit-draw", "underflow"])
def test_float32_model_at_an_extreme_correlation(u_rho, singular):
    """VI draws put the unconstrained correlation of a (1 + X4 | g.1) term
    near -20 (gaussian) and -89 (probit) in full-width float32 fits on the
    card, where float32 rounds the correlation to -1.  theta_L and the
    rho prior take log rho and log(1 - rho) from u, so theta_L stays
    regular and the log-density and its gradient finite.  Where even
    those underflow (-250) the factor is singular: the linear refresh and
    the level interweave keep that chain's state.  Either way their draws
    are finite, and the other chain moves."""
    d = generate_friedman_data(N, ranef=True)
    pmf = port_mf(FORMULA, friedman_dataframe(d))
    ppm, _, _ = port_pm(pmf, "gaussian", dtype=torch.float32, device="cpu")
    prog = PortProgram(ppm, PortBartConfig(num_trees=T), pmf.y, pmf.bart_X,
                       warmup=5, iterations=5, dtype=torch.float32,
                       device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    st = prog.init_state(gen, C)
    q = st.nuts.q.clone()
    q[:, ppm.layout.slices["rho"][0]] = torch.tensor([u_rho, 0.3])
    c, _ = ppm.layout.constrain(q)
    theta_L = ppm.transformed(c)["theta_L"]
    assert bool((theta_L[0] == 0).any()) == singular
    with torch.enable_grad():
        qg = q.clone().requires_grad_(True)
        (g,) = torch.autograd.grad(
            ppm.log_prob(qg, st.stan_offset, prog.y).sum(), qg)
    assert torch.isfinite(g).all()
    q_lg = ppm.linear_gibbs_refresh(q, st.stan_offset, prog.y, gen)
    nuts, bart = prog._level_gibbs_update(st.nuts._replace(q=q), st.bart,
                                          st.bart_offset, st.latents, gen)
    for new in (q_lg, nuts.q):
        assert torch.isfinite(new).all()
        assert not torch.equal(new[1], q[1])
        if singular:
            assert torch.equal(new[0], q[0])
    assert torch.isfinite(bart.allfit).all()
    if singular:
        assert torch.equal(bart.allfit[0], st.bart.allfit[0])

"""The four non-default ``offset_type``s of the port against the JAX
package (init.cpp:762-795 and 831-839; man/stan4bart.Rd:91-97).

``GibbsProgram._bart_offset_from_draw`` and ``_stan_offset_from_fit`` of
both packages on the same float64 model, user offset, parameter vectors
and BART fits: equal to 1e-12 (the same sums). The linear / level
interweave flags equal the reference's for every type, with its warning
on an explicit ``level_gibbs=True``. Then one small fit of the port per
type (n = 120, 2 chains, 10 iterations, 10 trees, treedepth capped at
4, on the CPU): finite draws, the level interweave off (asked off for
the default type), and the last iteration's offsets replaced as the
type says
(tests/test_offset_types.py's replacement semantics, held exactly on the
sampler's own state rather than by the reference's statistical gates,
which need 250 iterations)."""

import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import stan4bart_torch
from stan4bart_torch.formula import build_model_frame as port_mf
from stan4bart_torch.gibbs import OFFSET_TYPES
from stan4bart_torch.gibbs import GibbsProgram as PortProgram
from stan4bart_torch.models.assemble import build_parametric_model as port_pm
from stan4bart_torch.ops.bart import BartConfig as PortBartConfig
from stan4bart_tpu.formula import build_model_frame as ref_mf
from stan4bart_tpu.gibbs import GibbsProgram as RefProgram
from stan4bart_tpu.models.assemble import build_parametric_model as ref_pm
from stan4bart_tpu.ops.bart import BartConfig as RefBartConfig
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FORMULA = "y ~ bart(X1 + X2 + X3 + X5) + X4 + (1 + X4 | g.1) + (1 | g.2)"
N, C = 120, 3
EXACT = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def data():
    d = generate_friedman_data(N, ranef=True)
    return d, friedman_dataframe(d)


@pytest.fixture(scope="module")
def models(data):
    d, df = data
    rmf, pmf = ref_mf(FORMULA, df), port_mf(FORMULA, df)
    rpm, _, _ = ref_pm(rmf, "gaussian", {})
    ppm, _, _ = port_pm(pmf, "gaussian", {}, dtype=torch.float64,
                        device="cpu")
    rng = np.random.default_rng(7)
    U = rng.uniform(-1, 1, size=(C, rpm.num_upars))
    fit = rng.normal(size=(C, N))
    offset = rng.normal(size=N)
    return d, rmf, pmf, rpm, ppm, U, fit, offset


def _programs(models, offset_type, offset=True, **kw):
    d, rmf, pmf, rpm, ppm, U, fit, uo = models
    uo = uo if offset else None
    y = np.asarray(rmf.y)
    rprog = RefProgram(rpm, RefBartConfig(num_trees=4), y, rmf.bart_X,
                       user_offset=uo, offset_type=offset_type, warmup=4,
                       iterations=4, **kw)
    pprog = PortProgram(ppm, PortBartConfig(num_trees=4), y, pmf.bart_X,
                        user_offset=uo, offset_type=offset_type, warmup=4,
                        iterations=4, dtype=torch.float64, device="cpu",
                        **kw)
    return rprog, pprog


@pytest.mark.parametrize("offset", [True, False])
@pytest.mark.parametrize("offset_type", OFFSET_TYPES)
def test_offsets_match_reference(models, offset_type, offset):
    """Both substitutions, per chain in the reference and for all chains
    at once in the port, with and without a user offset: 1e-12."""
    d, rmf, pmf, rpm, ppm, U, fit, uo = models
    rprog, pprog = _programs(models, offset_type, offset)

    def ref_bart_offset(u):
        c, _ = rpm.layout.constrain(u)
        return rprog._bart_offset_from_draw(c, rpm.transformed(c))

    want_b = np.asarray(jax.vmap(ref_bart_offset)(jnp.asarray(U)))
    want_s = np.asarray(jax.vmap(rprog._stan_offset_from_fit)(
        jnp.asarray(fit)))
    c, _ = ppm.layout.constrain(torch.as_tensor(U))
    got_b = pprog._bart_offset_from_draw(c, ppm.transformed(c, C))
    got_s = pprog._stan_offset_from_fit(torch.as_tensor(fit))
    assert got_b.shape == got_s.shape == (C, N)
    np.testing.assert_allclose(got_b.numpy(), want_b, **EXACT)
    np.testing.assert_allclose(got_s.numpy(), want_s, **EXACT)


@pytest.mark.parametrize("flags", [{}, {"level_gibbs": True},
                                   {"linear_gibbs": True}])
@pytest.mark.parametrize("offset_type", OFFSET_TYPES)
def test_interweave_flags_match_reference(models, offset_type, flags):
    """The linear / level pair: on together by default only under the
    default offset_type, as in the reference; an explicit level_gibbs
    that the type makes ineligible warns in both packages."""
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        rprog, _ = _programs(models, offset_type, **flags)
    with warnings.catch_warnings(record=True) as port_w:
        warnings.simplefilter("always")
        _, pprog = _programs(models, offset_type, **flags)
    assert (pprog.linear_gibbs, pprog.level_gibbs) == \
        (rprog.linear_gibbs, rprog.level_gibbs)
    assert pprog.level_gibbs == (offset_type == "default")

    def warned(ws):
        return any("level_gibbs requested" in str(w.message) for w in ws)

    assert warned(port_w) == warned(ref_w) == (
        offset_type != "default" and "level_gibbs" in flags)


@pytest.fixture(scope="module")
def fits(data):
    d, df = data
    out = {}
    for offset_type, offset in (("fixef", d["mu_fixef"]),
                                ("ranef", d["mu_ranef"]),
                                ("bart", d["mu_bart"]),
                                ("parametric", d["mu_fixef"] + d["mu_ranef"]),
                                ("default", np.full(N, 3.0))):
        out[offset_type] = (offset, stan4bart_torch.stan4bart(
            FORMULA, df, offset=offset, offset_type=offset_type, chains=2,
            warmup=5, iter=10, seed=13, verbose=-1, device="cpu",
            dtype=torch.float64, bart_args={"n.trees": 10},
            # the interweave moves b after the offset is formed; off for
            # the default type too, so the last draw row is the offset's;
            # the replacement holds at any NUTS treedepth
            stan_args={"level_gibbs": False, "max_treedepth": 4}))
    return out


@pytest.mark.parametrize("offset_type", OFFSET_TYPES)
def test_fit_replaces_the_component(fits, offset_type):
    """The sampler's last state: the BART offset is the parametric mean
    with the user offset added (default) or in place of X beta (fixef),
    of Z b (ranef) or of the whole mean (parametric); the Stan offset is
    the BART fit plus the user offset (default), the user offset in place
    of the BART fit (bart), or the BART fit alone; 1e-10 (the draw row
    against the state, both float64)."""
    offset, fit = fits[offset_type]
    for name in ("stan", "bart_train", "k"):
        assert np.all(np.isfinite(getattr(fit.draws, name))), name
    assert not fit.prog.level_gibbs and not fit.prog.linear_gibbs
    xb = fit._indiv_fixef(True)[:, -1]           # (chains, N)
    zb = fit._indiv_ranef(True)[:, -1]
    bart = fit.draws.bart_train[:, -1]
    want_b = {"default": xb + zb + offset, "fixef": zb + offset,
              "ranef": xb + offset, "bart": xb + zb,
              "parametric": np.broadcast_to(offset, xb.shape)}[offset_type]
    want_s = {"default": bart + offset,
              "bart": np.broadcast_to(offset, bart.shape)}.get(offset_type,
                                                              bart)
    st = fit.final_states
    np.testing.assert_allclose(st.bart_offset.numpy(), want_b, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(st.stan_offset.numpy(), want_s, rtol=1e-10,
                               atol=1e-10)
    # the expanded user offset was never written through
    np.testing.assert_array_equal(fit.prog.user_offset.numpy(), offset)

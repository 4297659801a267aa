"""The port's default fit against the JAX package's, end to end on the CPU.

One small fit of each package on the same Friedman data (n = 200, 20
trees, 2 chains, 70 iterations of which 50 warmup, treedepth capped at
6; the reference's in a thread beside the port's): the draw-row layout
must match, the reference's final state must carry into the port, and
the posteriors must agree within Monte-Carlo error — the two samplers
share no random stream, so agreement is statistical:

* cor(posterior-mean BART fit of the port, of the reference) >= 0.95;
* posterior-mean sigma within 0.5 of each other: at 50 warmup
  iterations both are still relaxing from above, and over seeds 3-7 the
  difference ran 0.01-0.25 (seed-to-seed sd of the difference about 0.16,
  so 0.5 is three of them);
* posterior-mean fixed effects within 3 posterior standard deviations.

Seeds 3-7 at 100 iterations (50 warmup) and at 70 gave the same margins:
cor 0.974-0.979 and 0.966-0.977, sigma differences of sd 0.16 at both,
fixed effects within 1.3 sd at most.  The probit fit and the entry-point
checks are in tests/test_torch_entry_points.py."""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import stan4bart_torch
import stan4bart_tpu
from stan4bart_torch.convert import state_from_numpy
from stan4bart_tpu.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)

torch.set_num_threads(2)

FLAGSHIP = ("y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 + X4 | g.1) "
            "+ (1 | g.2)")
N, CHAINS, ITER, WARMUP = 200, 2, 70, 50
KW = dict(treatment="z", chains=CHAINS, iter=ITER, warmup=WARMUP, verbose=-1,
          stan_args={"max_treedepth": 6}, bart_args={"n.trees": 20})


@pytest.fixture(scope="module")
def fits():
    d = generate_friedman_data(N, ranef=True, causal=True)
    df = friedman_dataframe(d)
    # the reference compiles and runs in a thread beside the port's fit
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(stan4bart_tpu.stan4bart, FLAGSHIP, df, seed=3,
                          **KW)
        port = stan4bart_torch.stan4bart(FLAGSHIP, df, seed=3, device="cpu",
                                         dtype=torch.float64, **KW)
        ref = ref.result()
    return d, ref, port


def test_draw_layout_matches(fits):
    d, ref, port = fits
    assert port.stan_names == ref.stan_names
    kept = ITER - WARMUP
    for typ in ("stan", "ev", "indiv.bart", "indiv.fixef", "indiv.ranef",
                "fixef", "sigma", "varcount", "k"):
        assert port.extract(typ).shape == ref.extract(typ).shape, typ
    assert port.extract("ev", sample="test").shape == (N, kept * CHAINS)
    assert port.extract("stan", include_warmup=True).shape[-1] == \
        ITER * CHAINS
    assert port.extract("ranef").keys() == ref.extract("ranef").keys()
    for name in ("stan", "bart_train", "bart_test", "varcount", "k"):
        assert np.all(np.isfinite(getattr(port.draws, name))), name
    s = port.summary()
    assert s["names"] == ref.summary()["names"]
    assert np.all(np.isfinite(s["rhat"])) and np.all(s["ess"] > 0)


def test_posteriors_agree(fits):
    d, ref, port = fits
    bp, br = port.fitted("indiv.bart"), ref.fitted("indiv.bart")
    cor = np.corrcoef(bp - bp.mean(), br - br.mean())[0, 1]
    assert cor >= 0.95, f"cor(port bart, reference bart) = {cor}"
    truth = d["mu_bart"] - d["mu_bart"].mean()
    assert np.corrcoef(bp - bp.mean(), truth)[0, 1] >= 0.9
    s_p, s_r = float(port.fitted("sigma")), float(ref.fitted("sigma"))
    assert abs(s_p - s_r) < 0.5, (s_p, s_r)
    fx_p, fx_r = port.fitted("fixef"), ref.fitted("fixef")
    sd = port.extract("fixef").std(axis=-1)
    assert np.all(np.abs(fx_p - fx_r) < 3 * sd), (fx_p, fx_r, sd)
    ev = port.fitted("ev")
    parts = (port.fitted("indiv.bart") + port.fitted("indiv.fixef")
             + port.fitted("indiv.ranef"))
    np.testing.assert_allclose(ev, parts, atol=1e-8)


def test_port_continues_from_reference_state(fits):
    """A final sampler state of the JAX fit carried into the port
    (convert.state_from_numpy): the port's log-density at it equals the
    reference's last lp__, and the port runs on from it."""
    d, ref, port = fits
    state = state_from_numpy(ref.final_states, device="cpu")
    lp = port.pm.log_prob(state.nuts.q, state.stan_offset, port.prog.y)
    np.testing.assert_allclose(lp.numpy(), ref.draws.stan[:, -1, 0],
                               rtol=1e-9)
    gen = torch.Generator()
    gen.manual_seed(0)
    new, draw = port.prog.step_batched(state, 0, False, gen)
    assert draw.stan.shape == (CHAINS, len(port.stan_names))
    assert torch.isfinite(draw.stan).all()
    assert torch.isfinite(new.bart.allfit).all()

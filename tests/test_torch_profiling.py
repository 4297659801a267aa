"""The port's per-phase profiler (``stan4bart_torch/utils/profiling.py``)
against the JAX package's contract (tests/test_profiling.py:51-80), on
the CPU at that test's sizes: the keys, positive phase times, a glue
residual clamped at zero, the formatted lines, and the probit path's
latent branch.  Contract, not speed."""

import pytest
import torch

from stan4bart_torch.formula import build_model_frame
from stan4bart_torch.gibbs import GibbsProgram
from stan4bart_torch.models.assemble import build_parametric_model
from stan4bart_torch.ops.bart import BartConfig
from stan4bart_torch.utils.friedman import (
    friedman_dataframe,
    generate_friedman_data,
)
from stan4bart_torch.utils.profiling import format_profile, profile_phases

torch.set_num_threads(2)

FORMULA = "y ~ bart(. - g.1 - g.2 - X4 - z) + X4 + z + (1 | g.1)"


def _prog(n, family, stan_args, warmup, iterations, binary=False):
    d = generate_friedman_data(n, ranef=True, causal=True, binary=binary)
    mf = build_model_frame(FORMULA, friedman_dataframe(d))
    pm, _, _ = build_parametric_model(mf, family, stan_args,
                                      dtype=torch.float64, device="cpu")
    return GibbsProgram(pm, BartConfig(num_trees=5), mf.y, mf.bart_X,
                        warmup=warmup, iterations=iterations,
                        dtype=torch.float64, device="cpu")


@pytest.fixture(scope="module")
def prog_and_states():
    prog = _prog(200, "gaussian", {"centered_ranef": True}, 10, 4)
    gen = torch.Generator()
    gen.manual_seed(3)
    states = prog.init_state(gen, 2)
    for it in range(10):
        states, _ = prog.step_batched(states, it, True, gen)
    return prog, prog._disengage(states)


def test_profile_phases_contract(prog_and_states):
    prog, states = prog_and_states
    before = states.bart.feature.clone()
    p = profile_phases(prog, states, n_iter=3, repeats=1)
    assert set(p) >= {"full", "nuts", "bart", "glue", "n_chains"}
    assert p["n_chains"] == 2 and p["n_iter"] == 3
    for k in ("full", "nuts", "bart"):
        assert p[k] > 0.0
    # glue is a residual, clamped at zero
    assert p["glue"] >= 0.0
    txt = format_profile(p)
    assert "full" in txt and "bart" in txt and "%" in txt
    assert len(txt.splitlines()) == 5
    # the state profiled is not advanced
    assert torch.equal(states.bart.feature, before)


def test_profile_phases_binary():
    # the binary path takes the latent branch of the bart loop
    prog = _prog(150, "binomial", {}, 6, 3, binary=True)
    gen = torch.Generator()
    gen.manual_seed(5)
    states = prog.init_state(gen, 2)
    assert prog.is_binary
    p = profile_phases(prog, states, n_iter=2, repeats=1)
    assert p["full"] > 0.0 and p["bart"] > 0.0

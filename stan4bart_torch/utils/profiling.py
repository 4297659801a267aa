"""Per-phase wall-clock profiling of the Gibbs hot loop.

Counterpart of ``stan4bart_tpu/utils/profiling.py``.  The reference
exposes only whole-phase wall-clock accumulators
(interruptable_sampler.hpp:101-102, warm/sample_delta_t); the actionable
breakdown is which part of a Gibbs iteration dominates: the NUTS
transition or the BART sweep.  ``profile_phases`` times three loops on
the program's device:

- ``full``  — the production ``GibbsProgram.step_batched``
  (post-warmup);
- ``nuts``  — the NUTS transition alone against a frozen offset;
- ``bart``  — the BART sweep alone (``GibbsProgram._sweep``: the sweep
  kernel on the card) against a frozen offset and sigma; for probit
  against the state's latents.

``nuts + bart`` < ``full`` indicates glue cost (constrain, offset
rebuild, test prediction).  All numbers are steady-state: one untimed
run precedes timing, and on a card every loop ends on
``torch.cuda.synchronize``.
"""

from __future__ import annotations

import time

import torch

from stan4bart_torch.ops.nuts import nuts_transition


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.no_grad()
def profile_phases(prog, states, n_iter: int = 25, repeats: int = 3):
    """Time the Gibbs phases on a chain-batched state.

    Parameters
    ----------
    prog : GibbsProgram
    states : a chain-batched GibbsState (e.g. out of warmup)
    n_iter : iterations per timed loop
    repeats : timed repetitions; the MIN is reported (steady-state)

    The loops draw from a generator on the program's device, seeded 0;
    ``states`` is not changed.

    Returns a dict ``{phase: ms_per_iter}`` with keys ``full``,
    ``nuts``, ``bart``, plus ``glue`` (= full - nuts - bart, clamped
    at 0), ``n_chains`` and ``n_iter``.
    """
    dev = prog.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n_chains = int(states.nuts.q.shape[0])

    def full_loop(state):
        for it in range(n_iter):
            state, _ = prog.step_batched(state, it, False, gen)

    def nuts_loop(state):
        y_stan = state.latents if prog.is_binary else prog.y
        logp = prog._logp(state.nuts.q, state.stan_offset, y_stan)
        nuts = state.nuts
        for _ in range(n_iter):
            nuts, _ = nuts_transition(logp, nuts, gen, prog.nuts_cfg,
                                      False, False, False,
                                      pool=prog.chain_pool)

    def bart_loop(state):
        c, _ = prog.pm.layout.constrain(state.nuts.q)
        aux = prog.pm.transformed(c, state.nuts.q.shape[0])["aux"]
        sigma = torch.ones_like(aux) if prog.is_binary else aux
        y_target = ((state.latents if prog.is_binary else prog.y)
                    - state.bart_offset)
        bart_state = state.bart
        for _ in range(n_iter):
            bart_state, _ = prog._sweep(bart_state, y_target, sigma, gen,
                                        False)

    out = {"n_chains": n_chains, "n_iter": n_iter}
    for name, fn in (("full", full_loop), ("nuts", nuts_loop),
                     ("bart", bart_loop)):
        fn(states)          # first run, untimed
        _sync(dev)
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            fn(states)
            _sync(dev)
            best = min(best, time.perf_counter() - t0)
        out[name] = best / n_iter * 1e3  # ms / iteration (whole batch)
    out["glue"] = max(0.0, out["full"] - out["nuts"] - out["bart"])
    return out


def format_profile(p: dict) -> str:
    lines = [
        f"per-iteration wall clock, {p['n_chains']} chains, "
        f"{p['n_iter']}-iteration loops (ms):"
    ]
    for k in ("full", "nuts", "bart", "glue"):
        share = 100.0 * p[k] / p["full"] if p["full"] else 0.0
        lines.append(f"  {k:5s} {p[k]:8.2f}  ({share:5.1f}%)")
    return "\n".join(lines)

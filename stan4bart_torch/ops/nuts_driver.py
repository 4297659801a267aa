"""Standalone NUTS sampling driver: warmup with Stan's windowed
adaptation, then sampling, for one chain.

Counterpart of ``stan4bart_tpu/ops/nuts_driver.py``, over the port's
chain-batched ``nuts_transition`` with ``q0`` as a batch of one; the Gibbs
loop drives ``nuts_transition`` directly instead.  ``logdensity_fn`` maps
(1, P) points to (1,) values.
"""

from __future__ import annotations

import torch

from stan4bart_torch.ops.nuts import (
    NutsConfig,
    NutsInfo,
    init_stepsize,
    make_adapt_schedule,
    nuts_init,
    nuts_transition,
)
from stan4bart_torch.utils.device import check_generator, resolve_device


@torch.no_grad()
def nuts_sample(logdensity_fn, q0, gen, num_warmup: int, num_samples: int,
                cfg: NutsConfig = NutsConfig(), stepsize0: float = 1.0,
                tune_stepsize: bool = True, device="cuda"):
    """-> (positions (num_samples, P), info of (num_samples,) tensors, the
    final NutsState without its chain axis).  Runs on the card unless
    ``device="cpu"``, with ``q0`` moved there; ``gen`` must be on that
    device."""
    device = resolve_device(device)
    check_generator(gen, device)
    q0 = torch.as_tensor(q0, device=device)[None]
    sched = make_adapt_schedule(num_warmup)
    n_sched = len(sched["adapt_stepsize"])
    state = nuts_init(q0, stepsize=stepsize0)
    if tune_stepsize:
        eps = init_stepsize(logdensity_fn, q0, state.inv_mass, stepsize0,
                            gen)
        state = state._replace(da=state.da._replace(
            log_eps=torch.log(eps), mu=torch.log(10.0 * eps)))
    for it in range(num_warmup):
        i = min(it, n_sched - 1)
        state, _ = nuts_transition(
            logdensity_fn, state, gen, cfg,
            bool(sched["adapt_stepsize"][i]), bool(sched["collect"][i]),
            bool(sched["window_end"][i]))
    qs, infos = [], []
    for _ in range(num_samples):
        state, info = nuts_transition(logdensity_fn, state, gen, cfg,
                                      False, False, False)
        qs.append(state.q[0])
        infos.append(info)
    info = NutsInfo(*(torch.cat(x) for x in zip(*infos)))
    return torch.stack(qs), info, _unbatch(state)


def _unbatch(t):
    """A (nested) NamedTuple of tensors without their leading axis."""
    if isinstance(t, tuple):
        return type(t)(*map(_unbatch, t))
    return t[0]

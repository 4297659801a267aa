"""Carry sampler states and stored draws of the JAX package into the port.

A state of the JAX package (``stan4bart_tpu.gibbs.GibbsState`` /
``stan4bart_tpu.ops.bart.BartState``, batched over chains) is turned
into numpy leaf by leaf and rebuilt here as the port's state, so both
implementations can start from the same point; a fit's stored draws
(``stan4bart_tpu.gibbs.GibbsDraw`` of numpy arrays with leading (chains,
iterations)) become the port's, so both fit objects can read the same
numbers.  The inputs may be the
JAX NamedTuples themselves or nested dicts of arrays with the same field
names; every leaf is copied into a numpy array.  Nothing of JAX is
imported.
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from stan4bart_torch.gibbs import GibbsDraw, GibbsState, ViState
from stan4bart_torch.ops.bart import BartState
from stan4bart_torch.ops.nuts import DualAveragingState, NutsState, WelfordState
from stan4bart_torch.utils.device import resolve_device


def _field(d, name):
    return d[name] if isinstance(d, Mapping) else getattr(d, name)


def _leaves(d, cls, dtype, device, int_fields=()):
    device = resolve_device(device)
    out = {}
    for name in cls._fields:
        a = np.array(_field(d, name))
        if name in int_fields:
            out[name] = torch.as_tensor(a.astype(np.int32), device=device)
        else:
            out[name] = torch.as_tensor(a.astype(np.float64), dtype=dtype,
                                        device=device)
    return cls(**out)


def bart_state_from_numpy(d, dtype=torch.float64, device="cuda") -> BartState:
    """A batched forest state (leading chain axis) as a port BartState."""
    return _leaves(d, BartState, dtype, device,
                   int_fields=("feature", "cut", "leaf_idx"))


def nuts_state_from_numpy(d, dtype=torch.float64, device="cuda") -> NutsState:
    """A batched NUTS state: q, inverse mass, dual-averaging and Welford
    accumulators, each with a leading chain axis."""
    device = resolve_device(device)
    return NutsState(
        q=torch.as_tensor(np.array(_field(d, "q"), np.float64),
                          dtype=dtype, device=device),
        inv_mass=torch.as_tensor(np.array(_field(d, "inv_mass"),
                                          np.float64),
                                 dtype=dtype, device=device),
        da=_leaves(_field(d, "da"), DualAveragingState, dtype, device),
        welford=_leaves(_field(d, "welford"), WelfordState, dtype, device),
    )


def state_from_numpy(d, dtype=torch.float64, device="cuda") -> GibbsState:
    """A batched Gibbs state: NUTS state, forest, offsets, latents and
    the variational state (zero-width fields under NUTS, as in the JAX
    package)."""
    device = resolve_device(device)
    def arr(name):
        return torch.as_tensor(np.array(_field(d, name), np.float64),
                               dtype=dtype, device=device)

    return GibbsState(
        nuts=nuts_state_from_numpy(_field(d, "nuts"), dtype, device),
        bart=bart_state_from_numpy(_field(d, "bart"), dtype, device),
        bart_offset=arr("bart_offset"),
        stan_offset=arr("stan_offset"),
        latents=arr("latents"),
        vi=_leaves(_field(d, "vi"), ViState, dtype, device),
    )


def draws_from_numpy(d) -> GibbsDraw:
    """A fit's stored draws, leading (chains, iterations), as the port's
    GibbsDraw of numpy arrays (what ``Stan4bartFit.draws`` holds): the
    stan rows, the train/test BART fits, varcount, k and, where they
    were kept, the stored forests.  The JAX package marks absent forests
    with zero-size placeholders; they become None here."""
    out = {}
    for name in GibbsDraw._fields:
        a = d.get(name) if isinstance(d, Mapping) else getattr(d, name, None)
        if a is not None:
            a = np.array(a)
            if a.size == 0 and name.startswith("tree_"):
                a = None
        out[name] = a
    return GibbsDraw(**out)

"""Device resolution shared by every entry point of the port."""

from __future__ import annotations

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; the default ``"cuda"`` raises
    when no CUDA device is present (no silent CPU run).  The CPU runs
    only when the caller asks for it with ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    # full-precision float32 products: reduced-precision sufficient
    # statistics break the sampler (NUTS stepsize adaptation collapses)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def check_generator(gen, dev: torch.device) -> None:
    """Raise unless ``gen`` (``None``: no generator) draws on ``dev``; a
    sampler never quietly draws on another device than the one asked
    for."""
    if gen is None:
        return
    g = gen.device
    if g.type != dev.type or (dev.index is not None
                              and g.index is not None
                              and g.index != dev.index):
        raise RuntimeError(
            f"the generator is on {g}, the sampler on {dev}; make the "
            f"generator with torch.Generator(device={str(dev)!r})"
        )


def card() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]

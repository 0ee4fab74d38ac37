"""Where an entry point runs: the card, unless the caller asks for the CPU.

Nothing in the port falls back to the CPU when there is no card: an entry
point given no ``device`` takes the current CUDA device or raises.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor", "move", "device_const"]


def resolve_device(device, who: str) -> torch.device:
    """``device`` when given, else the current CUDA device; without a card
    it raises RuntimeError naming ``device='cpu'``."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{who}: no CUDA device; pass device='cpu' to run on the CPU"
            )
        device = "cuda"
    return torch.device(device)


def as_tensor(x, device, who: str) -> torch.Tensor:
    """A tensor stays on its own device unless ``device`` names another;
    anything else (a NumPy array, a list) goes to ``resolve_device``."""
    if isinstance(x, torch.Tensor):
        return x if device is None else x.to(device)
    return torch.as_tensor(np.asarray(x), device=resolve_device(device, who))


def move(x: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``x`` on ``device``; a copy to a card does not wait for the host (a
    copy to the host does: its data is read next)."""
    return x if x.device == device else x.to(device, non_blocking=device.type == "cuda")


_CONSTS: dict = {}


def device_const(key, device, build):
    """``build()`` (a NumPy array, or a dict of them) as tensors on
    ``device``, built once per (key, device): a step that reads it then
    copies nothing from the host and never waits for the card."""
    full_key = (key, str(torch.device(device)))
    hit = _CONSTS.get(full_key)
    if hit is None:
        made = build()
        hit = _CONSTS[full_key] = (
            {name: torch.as_tensor(a, device=device) for name, a in made.items()}
            if isinstance(made, dict) else torch.as_tensor(made, device=device))
    return hit

"""Where the port's entry points run: the card, unless the caller asks for
the CPU. Asking for ``cuda`` on a machine without a card raises; nothing
falls back to the CPU."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is visible; pass device='cpu' "
                               "to run on the CPU")
        return dev
    if dev.type != "cpu":
        raise ValueError(f"the port runs on cuda or cpu, not {dev}")
    return dev

"""Device choice and card identification.

Entry points take a `device` argument. `None` means the card
(`cuda:0`); a caller that wants the CPU says so with `device="cpu"`.
There is no silent fallback: without a card, `default_device()` raises.
"""

from __future__ import annotations

import subprocess

import torch


def default_device() -> torch.device:
    """`cuda:0`, or RuntimeError when no CUDA device is present."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return torch.device("cuda", 0)


def resolve_device(device: str | torch.device | None) -> torch.device:
    """The device an entry point runs on: the card for None, else the
    one named."""
    if device is None:
        return default_device()
    return torch.device(device)


def card_info() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`,
    one line per card: printed beside every number measured on it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()

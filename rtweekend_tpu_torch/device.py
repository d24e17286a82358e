"""Device selection shared by the entry points."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`None` means the card. The CPU is used only when asked for by name;
    without a card and without that request this raises, never falls back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' (CLI: --cpu) "
                "to run on the CPU"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is not available")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use 'cuda' or 'cpu'")
    return dev


def describe(dev: torch.device) -> str:
    """What a measurement ran on: for the card, `nvidia-smi`'s name and power
    limit (a card set below its maximum runs slower under load); "cpu"
    otherwise. The card is named to nvidia-smi by its UUID: nvidia-smi
    numbers cards in PCI order and ignores CUDA_VISIBLE_DEVICES, so its
    index need not be the CUDA ordinal."""
    if dev.type != "cuda":
        return "cpu"
    import subprocess

    uuid = torch.cuda.get_device_properties(
        torch.cuda.current_device() if dev.index is None else dev.index).uuid
    return subprocess.run(
        ["nvidia-smi", f"--id=GPU-{uuid}", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def synchronize(dev: torch.device) -> None:
    """Wait for the card's queued work; the CPU's is already done."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

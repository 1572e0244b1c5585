"""Complexity report; counterpart of ``refvsr_tpu/utils/profiling.py``'s
``param_count`` and ``write_cost_report``. The JAX Runner writes the report
without a function to analyse, so ``cost.txt`` carries the parameter count
only; XLA's cost analysis has no counterpart here."""

from __future__ import annotations

import os

import torch


def param_count(module: torch.nn.Module) -> int:
    """Elements of every parameter of `module`, trained or frozen."""
    return sum(p.numel() for p in module.parameters())


def write_cost_report(path: str, module: torch.nn.Module):
    """Write cost.txt with the parameter count in millions; returns its
    lines."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    lines = [f"Number of parameters:           "
             f"{param_count(module) / 1e6:.4f} M"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    return lines

"""Timing on the card shared by the probe scripts, the profiler and
chip_smoke.py: launches timed between two CUDA events, and the card's
name and power limit, which every kept number carries."""
from __future__ import annotations

import subprocess

import torch

REPS = 16
BEST_OF = 3


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def time_launches(fn, reps: int = REPS, best_of: int = BEST_OF) -> float:
    """Milliseconds per call: `reps` calls back to back between two CUDA
    events, the best of `best_of` runs, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(best_of):
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / reps)
    return best

"""The card's state beside every run: name, power limit, clocks and
temperature as ``nvidia-smi`` reads them, and the process's own start.

A card may be set below its 700 W limit and then runs slower under load,
so every run prints these on its first lines.
"""
from __future__ import annotations

import os
import subprocess

__all__ = ["QUERY", "card_lines", "process_age_s"]

QUERY = ("name,power.limit,power.draw,clocks.sm,clocks.max.sm,clocks.mem,"
         "temperature.gpu")


def card_lines() -> list[str]:
    """One csv line per card, in ``QUERY``'s order; a note where
    ``nvidia-smi`` does not answer."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={QUERY}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
        return [ln.strip() for ln in out.splitlines() if ln.strip()]
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable: {type(e).__name__}"]


def process_age_s() -> float:
    """Seconds since this process started (Linux ``/proc``, 10 ms
    resolution): the part of set-up before the first line of Python."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(up - start, 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0

"""Published peaks the rooflines divide by: frozen here, so that a change
to the program cannot move the yardstick.

NVIDIA H100 SXM5 80 GB (NVIDIA's data sheet): 3.35 TB/s of HBM3 bandwidth
at the full 700 W power limit. A card set below 700 W runs slower under
load; each run reports the card's ``power.limit`` beside its numbers
(``card()``), and shares are stated against the published peak.
"""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
PUBLISHED_POWER_LIMIT_W = 700.0


def card() -> dict:
    """The card's name and power limit as ``nvidia-smi`` reads them (empty
    where it cannot)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return {}
    line = out.stdout.strip().splitlines()[0] if out.stdout.strip() else ""
    name, _, limit = line.rpartition(",")
    return {"name": name.strip(), "power_limit": limit.strip()} if line \
        else {}


def roofline_pct(nbytes: float, seconds: float):
    """The share, in %, of the least time ``nbytes`` moved once through HBM
    takes, of ``seconds``; None where nothing was timed."""
    if seconds <= 0 or nbytes <= 0:
        return None
    return 100.0 * nbytes / HBM_BYTES_PER_S / seconds

"""The least time the card could take for a kernel's work, from the
algorithm's inputs (never from the padded slabs the program hands its
kernels, so that a change of layout cannot move the yardstick).

Each input byte is counted as read once and each output byte as written
once; the least time is the larger of bytes over the memory bandwidth and
operations over the compute rate. Peaks are NVIDIA's data sheet for the
H100 SXM at its full power limit of 700 W (dense rates): 3.35 TB/s of
HBM3, 67 TFLOP/s of float32 outside the tensor cores, taken here for
int32 operations too. ``power_limit`` reads the card's limit, reported
beside every share, since a card set below 700 W runs slower under load.
"""
from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
OPS_PER_S = 67e12


def least_seconds(nbytes: float, ops: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, ops / OPS_PER_S)


def lp_move(rows: int, arcs: int) -> tuple:
    """``(bytes, ops)`` of one LP-move pass over ``rows`` vertices with
    ``arcs`` arcs in all: per arc the neighbour's label, the arc's weight
    and the label's cluster weight (12 bytes) and two operations (the
    label's connection sum, the admission compare); per vertex its label
    and weight read and its move flag and target written (16 bytes)."""
    return 12 * arcs + 16 * rows, 2 * arcs


def bal_scores(rows: int, rows_over: int, arcs_over: int) -> tuple:
    """``(bytes, ops)`` of one balancing round's scores: every vertex's
    block read (4 bytes) to find those of overloaded blocks; for each of
    those its arcs' neighbour blocks and weights (8 bytes an arc, two
    operations), its weight read and its gain and target written (12
    bytes)."""
    return 4 * rows + 8 * arcs_over + 12 * rows_over, 2 * arcs_over


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of the card, or a note that
    it could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
        return out.splitlines()[0] if out else "unread"
    except (OSError, subprocess.SubprocessError):
        return "unread"

"""Seeded lint violations (AST-scanned only, never run by the pipeline):
draws from the global numpy and Python RNG states (LNT001), a
collective without ``group=`` (LNT002), and an ``.item()`` device sync
treated as serve-hot-path code (LNT003).
"""

import random

import numpy as np
import torch.distributed as dist


def noisy(x):
    noise = np.random.rand(*x.shape)  # LNT001: global numpy RNG
    pick = random.random()  # LNT001: global Python RNG
    return x + noise + pick


def summed(t):
    dist.all_reduce(t)  # LNT002: no explicit group=
    return t


def hot_path(result):
    return result.assignment.item()  # LNT003: device sync per request

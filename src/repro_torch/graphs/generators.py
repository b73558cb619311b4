"""KaGen-style synthetic graph generators (numpy host-side; the port's own
copy of ``repro.graphs.generators``, same seeds, same graphs).

The paper evaluates on rgg2d / rgg3d / rhg families plus real-world meshes
and complex networks. We reproduce the same families at laptop scale:

  * rgg2d / rgg3d — random geometric graphs, radius chosen for a target
    average degree (KaGen semantics).
  * rhg — random hyperbolic graph, power-law exponent 3 by default. Exact
    threshold model for small n, Chung–Lu power-law approximation beyond
    (documented; the partitioner only cares about the skewed-degree regime).
  * grid2d / grid3d — deterministic meshes (nlpkkt/europe.osm proxies).
  * ba — Barabási–Albert preferential attachment (social-network proxy).
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from .format import Graph, from_coo


def rgg2d(n: int, avg_deg: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    # E[deg] = n * pi r^2  ->  r = sqrt(avg_deg / (pi n))
    r = np.sqrt(avg_deg / (np.pi * n))
    tree = cKDTree(pts)
    pairs = tree.query_pairs(r, output_type="ndarray")
    return from_coo(n, pairs[:, 0], pairs[:, 1])


def rgg3d(n: int, avg_deg: float, seed: int = 0) -> Graph:
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3))
    r = (avg_deg / ((4.0 / 3.0) * np.pi * n)) ** (1.0 / 3.0)
    tree = cKDTree(pts)
    pairs = tree.query_pairs(r, output_type="ndarray")
    return from_coo(n, pairs[:, 0], pairs[:, 1])


def _rhg_exact(n: int, avg_deg: float, gamma: float, seed: int) -> Graph:
    """Threshold random hyperbolic graph, blocked O(n^2); n <= ~20k."""
    rng = np.random.default_rng(seed)
    alpha = (gamma - 1.0) / 2.0
    R = 2.0 * np.log(n) - np.log(avg_deg)  # calibration; refined below
    # radial cdf: F(r) = (cosh(alpha r) - 1) / (cosh(alpha R) - 1)
    u = rng.random(n)
    r = np.arccosh(1.0 + u * (np.cosh(alpha * R) - 1.0)) / alpha
    theta = rng.random(n) * 2.0 * np.pi
    cr, sr = np.cosh(r), np.sinh(r)
    srcs, dsts = [], []
    block = 2048
    for i0 in range(0, n, block):
        i1 = min(i0 + block, n)
        dtheta = np.abs(theta[i0:i1, None] - theta[None, :])
        dtheta = np.minimum(dtheta, 2.0 * np.pi - dtheta)
        cosh_d = (cr[i0:i1, None] * cr[None, :]
                  - sr[i0:i1, None] * sr[None, :] * np.cos(dtheta))
        adj = cosh_d <= np.cosh(R)
        ii, jj = np.nonzero(adj)
        ii = ii + i0
        keep = ii < jj
        srcs.append(ii[keep])
        dsts.append(jj[keep])
    src = np.concatenate(srcs) if srcs else np.empty(0, np.int64)
    dst = np.concatenate(dsts) if dsts else np.empty(0, np.int64)
    return from_coo(n, src, dst)


def _chung_lu_powerlaw(n: int, avg_deg: float, gamma: float, seed: int) -> Graph:
    rng = np.random.default_rng(seed)
    # degree weights ~ pareto with exponent gamma
    w = (1.0 - rng.random(n)) ** (-1.0 / (gamma - 1.0))
    w *= avg_deg * n / w.sum()
    m_target = int(avg_deg * n / 2)
    p = w / w.sum()
    src = rng.choice(n, size=2 * m_target, p=p)
    dst = rng.choice(n, size=2 * m_target, p=p)
    keep = src != dst
    return from_coo(n, src[keep], dst[keep])


def rhg(n: int, avg_deg: float, gamma: float = 3.0, seed: int = 0) -> Graph:
    if n <= 20000:
        return _rhg_exact(n, avg_deg, gamma, seed)
    return _chung_lu_powerlaw(n, avg_deg, gamma, seed)


def grid2d(nx: int, ny: int) -> Graph:
    n = nx * ny
    ids = np.arange(n).reshape(nx, ny)
    right = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    down = np.stack([ids[:-1, :].ravel(), ids[1:, :].ravel()], axis=1)
    e = np.concatenate([right, down])
    return from_coo(n, e[:, 0], e[:, 1])


def grid3d(nx: int, ny: int, nz: int) -> Graph:
    n = nx * ny * nz
    ids = np.arange(n).reshape(nx, ny, nz)
    ex = np.stack([ids[:-1].ravel(), ids[1:].ravel()], axis=1)
    ey = np.stack([ids[:, :-1].ravel(), ids[:, 1:].ravel()], axis=1)
    ez = np.stack([ids[:, :, :-1].ravel(), ids[:, :, 1:].ravel()], axis=1)
    e = np.concatenate([ex, ey, ez])
    return from_coo(n, e[:, 0], e[:, 1])


def ba(n: int, m_attach: int = 4, seed: int = 0) -> Graph:
    """Barabási–Albert via the repeated-nodes trick (vectorized-ish)."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated: list[int] = []
    src, dst = [], []
    for v in range(m_attach, n):
        for t in targets:
            src.append(v)
            dst.append(t)
        repeated.extend(targets)
        repeated.extend([v] * m_attach)
        # sample next targets (with repetition tolerated; dedup in from_coo)
        idx = rng.integers(0, len(repeated), size=m_attach)
        targets = [repeated[i] for i in idx]
    return from_coo(n, np.array(src), np.array(dst))


def random_regular_ish(n: int, deg: int, seed: int = 0) -> Graph:
    """Fast approximately-regular random graph (union of deg/2 permutations)."""
    rng = np.random.default_rng(seed)
    srcs, dsts = [], []
    for _ in range(max(1, deg // 2)):
        p = rng.permutation(n)
        srcs.append(np.arange(n))
        dsts.append(p)
    return from_coo(n, np.concatenate(srcs), np.concatenate(dsts))


def weighted_variant(g: Graph, seed: int = 0,
                     max_vw: int = 8, max_ew: int = 8) -> Graph:
    """Attach random integer vertex/edge weights (for weighted-instance tests)."""
    rng = np.random.default_rng(seed)
    src = g.arc_tails()
    # symmetric edge weights: hash the unordered pair
    lo = np.minimum(src, g.adjncy)
    hi = np.maximum(src, g.adjncy)
    ew = (np.asarray(lo, np.uint64) * np.uint64(2654435761)
          ^ np.asarray(hi, np.uint64) * np.uint64(40503)) % np.uint64(max_ew) + np.uint64(1)
    vw = rng.integers(1, max_vw + 1, size=g.n)
    return Graph(indptr=g.indptr, adjncy=g.adjncy,
                 eweights=ew.astype(np.int64), vweights=vw.astype(np.int64))


_FAMILIES = {
    "rgg2d": lambda n, d, s: rgg2d(n, d, s),
    "rgg3d": lambda n, d, s: rgg3d(n, d, s),
    "rhg": lambda n, d, s: rhg(n, d, 3.0, s),
    "ba": lambda n, d, s: ba(n, max(1, int(d) // 2), s),
    "grid2d": lambda n, d, s: grid2d(int(np.sqrt(n)), int(np.sqrt(n))),
    "rr": lambda n, d, s: random_regular_ish(n, int(d), s),
}


def make(family: str, n: int, avg_deg: float = 8.0, seed: int = 0) -> Graph:
    return _FAMILIES[family](n, avg_deg, seed)

"""The benchmark's input graphs, made from the seed on the host in bulk.

KaGen's families as the dKaMinPar paper uses them: ``rgg2d`` (random
geometric graph in the unit square, radius set for the average degree) and
``rhg`` (the threshold random hyperbolic graph, power-law degrees with
exponent gamma, the disk's radius set for the average degree, generated
band by band at any size). ``rgg2d`` gives the program's own rgg2d graph
of a seed arc for arc; this copy keeps the inputs out of the program's
hands.

A graph is four numpy arrays: ``indptr`` (n + 1, int64), ``adjncy`` (m,
int32, each undirected edge as two arcs), ``eweights`` and ``vweights``
(int64, all ones here).
"""
from __future__ import annotations

import numpy as np
from scipy.optimize import brentq
from scipy.spatial import cKDTree


def from_pairs(n: int, src: np.ndarray, dst: np.ndarray):
    """CSR of the undirected graph on ``n`` vertices with edges (src, dst):
    self loops dropped, both directions stored, parallel arcs merged (their
    weights summed), arcs sorted by (tail, head)."""
    src = np.asarray(src, dtype=np.int64)
    dst = np.asarray(dst, dtype=np.int64)
    keep = src != dst
    src, dst = src[keep], dst[keep]
    src, dst = np.concatenate([src, dst]), np.concatenate([dst, src])
    w = np.ones(src.shape[0], dtype=np.int64)
    if src.size:
        key = src * n + dst
        order = np.argsort(key, kind="stable")
        key, src, dst = key[order], src[order], dst[order]
        first = np.concatenate([[True], key[1:] != key[:-1]])
        seg = np.cumsum(first) - 1
        w = np.zeros(int(seg[-1]) + 1, dtype=np.int64)
        np.add.at(w, seg, 1)
        src, dst = src[first], dst[first]
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(src, minlength=n))
    return indptr, dst.astype(np.int32), w, np.ones(n, dtype=np.int64)


def rgg2d(n: int, avg_deg: float, seed: int):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    r = np.sqrt(avg_deg / (np.pi * n))      # E[deg] = n pi r^2
    pairs = cKDTree(pts).query_pairs(r, output_type="ndarray")
    return from_pairs(n, pairs[:, 0], pairs[:, 1])


def _theta_max(r1, r2, R: float):
    """The widest angle at which points at radii r1 and r2 lie within
    hyperbolic distance R of each other (pi where every angle does)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        c = (np.cosh(r1) * np.cosh(r2) - np.cosh(R)) \
            / (np.sinh(r1) * np.sinh(r2))
    return np.arccos(np.clip(np.where(np.isnan(c), -1.0, c), -1.0, 1.0))


def rhg_radius(n: int, avg_deg: float, gamma: float, nodes: int = 200
               ) -> float:
    """The disk's radius R at which the threshold model's expected average
    degree, (n - 1) E[theta_max(r1, r2) / pi] over the radial law, is
    ``avg_deg``. The expectation is taken over the law's quantile u by
    Gauss-Legendre in t = -ln u, which resolves the few central points
    (the hubs) that carry much of it."""
    alpha = (gamma - 1.0) / 2.0
    x, w = np.polynomial.legendre.leggauss(nodes)
    t_max = 60.0
    u = np.exp(-(x + 1.0) * t_max / 2.0)
    wu = w * t_max / 2.0 * u

    def excess(R):
        r = np.arccosh(1.0 + u * (np.cosh(alpha * R) - 1.0)) / alpha
        mean = (wu[:, None] * wu[None, :]
                * _theta_max(r[:, None], r[None, :], R)).sum() / np.pi
        return (n - 1) * mean - avg_deg
    R0 = 2.0 * np.log(n)
    return float(brentq(excess, 0.25 * R0, 2.0 * R0, xtol=1e-12))


def _rhg_pairs(r, theta, R: float, band: float = 0.5):
    """Every pair (u < v) within distance R, found band by band: vertices
    fall into radial bands of width ``band``; each vertex looks, in each
    band, only at the vertices whose angle lies within the widest angle
    any of them could connect at (that of the band's inner radius), and
    tests those exactly, with the same arithmetic as an all-pairs sweep."""
    n = r.shape[0]
    cr, sr, cosh_R = np.cosh(r), np.sinh(r), np.cosh(R)
    inner = np.arange(0.0, R + band, band)
    of = np.searchsorted(inner, r, side="right") - 1
    ids = np.arange(n)
    srcs, dsts = [], []
    for j, b in enumerate(inner):
        members = np.flatnonzero(of == j)
        if members.size == 0:
            continue
        members = members[np.argsort(theta[members], kind="stable")]
        size = members.size
        th = theta[members]
        ext = np.concatenate([th - 2.0 * np.pi, th, th + 2.0 * np.pi])
        phi = _theta_max(r, b, R) + 1e-9
        lo = np.searchsorted(ext, theta - phi, side="left")
        hi = np.searchsorted(ext, theta + phi, side="right")
        whole = (phi >= np.pi) | (hi - lo > size)
        lo = np.where(whole, size, lo)
        cnt = np.where(whole, size, hi - lo)
        total = int(cnt.sum())
        if total == 0:
            continue
        u = np.repeat(ids, cnt)
        first = np.repeat(lo - (np.cumsum(cnt) - cnt), cnt)
        v = members[(np.arange(total) + first) % size]
        keep = u < v
        u, v = u[keep], v[keep]
        dtheta = np.abs(theta[u] - theta[v])
        dtheta = np.minimum(dtheta, 2.0 * np.pi - dtheta)
        near = cr[u] * cr[v] - sr[u] * sr[v] * np.cos(dtheta) <= cosh_R
        srcs.append(u[near])
        dsts.append(v[near])
    empty = np.empty(0, dtype=np.int64)
    return (np.concatenate(srcs) if srcs else empty,
            np.concatenate(dsts) if dsts else empty)


def rhg(n: int, avg_deg: float, gamma: float, seed: int, radius=None):
    """KaGen's threshold random hyperbolic graph: n points in a disk of
    radius R, radii by the density alpha sinh(alpha r) / (cosh(alpha R) -
    1) with alpha = (gamma - 1) / 2, angles uniform, an edge wherever two
    points lie within R. R is set so that the expected average degree is
    ``avg_deg`` (``rhg_radius``) unless ``radius`` is given."""
    rng = np.random.default_rng(seed)
    alpha = (gamma - 1.0) / 2.0
    R = rhg_radius(n, avg_deg, gamma) if radius is None else float(radius)
    u = rng.random(n)
    r = np.arccosh(1.0 + u * (np.cosh(alpha * R) - 1.0)) / alpha
    theta = rng.random(n) * 2.0 * np.pi
    return from_pairs(n, *_rhg_pairs(r, theta, R))


FAMILIES = {
    "rgg2d": lambda cfg, seed: rgg2d(cfg["n"], cfg["avg_deg"], seed),
    "rhg": lambda cfg, seed: rhg(cfg["n"], cfg["avg_deg"], cfg["gamma"],
                                 seed),
}


def make(cfg: dict, seed: int):
    """The configuration's graph for ``seed``: ``(indptr, adjncy, eweights,
    vweights)``."""
    try:
        family = FAMILIES[cfg["family"]]
    except KeyError:
        raise ValueError(f"no generator for the family {cfg['family']!r}; "
                         f"the benchmark has {sorted(FAMILIES)}") from None
    return family(cfg, seed)

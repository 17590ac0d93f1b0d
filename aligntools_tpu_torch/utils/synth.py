"""Synthetic workloads: ``clustered_pairs`` is copied from
``aligntools_tpu/utils/synth.py``; ``related_pair`` is the port's own."""

from __future__ import annotations

import numpy as np


def clustered_pairs(P: int, seed: int = 7) -> list[tuple[bytes, bytes]]:
    """The length-clustered synthetic read set: m ~ lognormal(300, 0.2),
    n ~ lognormal(3000, 0.25), random ACGT."""
    rng = np.random.default_rng(seed)
    alpha = list(b"ACGT")
    ms = np.exp(rng.normal(np.log(300), 0.2, P)).astype(int)
    ns = np.exp(rng.normal(np.log(3000), 0.25, P)).astype(int)
    return [
        (bytes(rng.choice(alpha, max(1, int(a))).tolist()),
         bytes(rng.choice(alpha, max(1, int(b))).tolist()))
        for a, b in zip(ms, ns)
    ]


def related_pair(m: int, n: int, seed: int = 7, sub: float = 0.01,
                 indel: float = 0.005, offset: int | None = None
                 ) -> tuple[bytes, bytes]:
    """A query of about m bases drawn from a random ACGT target of n >= m
    bases (a contig against the region it came from): the window of the
    target at ``offset`` (drawn when None) with ``sub`` substitutions and
    ``indel`` single-base indels a base, half insertions, half
    deletions."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    t = alpha[rng.integers(0, 4, n)]
    off = int(rng.integers(0, n - m + 1)) if offset is None else offset
    q = t[off : off + m].copy()
    hit = rng.random(m) < sub
    q[hit] = alpha[rng.integers(0, 4, int(hit.sum()))]
    at = np.flatnonzero(rng.random(m) < indel)
    ins = rng.random(len(at)) < 0.5
    copies = np.ones(m, int)
    copies[at[~ins]] = 0
    copies[at[ins]] = 2
    q = np.repeat(q, copies)
    # an inserted base follows its position's own
    q[(np.cumsum(copies) - 1)[at[ins]]] = alpha[
        rng.integers(0, 4, int(ins.sum()))]
    return q.tobytes(), t.tobytes()

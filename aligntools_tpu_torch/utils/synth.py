"""Synthetic workloads; copied from ``aligntools_tpu/utils/synth.py``."""

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

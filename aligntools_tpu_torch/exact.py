"""The float32 exactness guard of the score fills.

Copied from ``aligntools_tpu/engine/scan.py:57-84``: that module imports
jax, which the port never loads. Scores are float32 holding exact
integers; DP magnitudes are bounded by max|param| * (path length <=
m+n+1), so the fills are exact iff that bound stays below 2^24.
"""

from __future__ import annotations

F32_EXACT_LIMIT = 1 << 24


def f32_exact(p, m: int, n: int, mode: str = "global") -> bool:
    """True when every DP value for this (params, lengths) combination is
    an integer representable exactly in float32."""
    if mode == "edit":
        mx = max(1, abs(p.mismatch))
    else:
        mx = max(abs(p.match), abs(p.mismatch), abs(p.gap_open),
                 abs(p.gap_extend), abs(p.jump))
    return mx * (m + n + 1) < F32_EXACT_LIMIT


def check_f32_exact(p, m: int, n: int, mode: str = "global") -> None:
    """Raise when the f32 fills would lose integer exactness: the
    reference computes in double (alignment.h:37-48), and the port has no
    double-precision engine, so it refuses the pair rather than diverge."""
    if not f32_exact(p, m, n, mode):
        raise ValueError(
            f"scoring params x sequence lengths exceed the float32 "
            f"exact-integer range (max|param| * (m+n+1) >= 2^24 for "
            f"m={m}, n={n}); aligntools_tpu_torch refuses such a pair (the "
            f"JAX package's spec engine answers it in double precision)"
        )

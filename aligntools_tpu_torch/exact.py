"""The exactness ranges of the fills: float32's, and the double instances'.

Copied from ``aligntools_tpu/engine/scan.py:57-84``: that module imports
jax, which the port never loads. Scores are floats holding exact
integers; DP magnitudes are bounded by max|param| * (path length <=
m+n+1), so the float32 fills are exact iff that bound stays below 2^24,
and the double instances iff it stays below 2^53.

``batch.align_batch`` (``batch``, ``serve``, ``--band``) refuses a pair
past float32's range, as the JAX ``align_batch`` does. ``api.align_pair``
sends such a pair to the double instances of the same kernels, where the
JAX ``align_pair`` sends it to its double-precision spec engine; neither
refuses a pair past 2^53, where double rounds as the reference's own
double does (alignment.h:37-48).
"""

from __future__ import annotations

F32_EXACT_LIMIT = 1 << 24
F64_EXACT_LIMIT = 1 << 53


def dp_bound(p, m: int, n: int, mode: str = "global") -> int:
    """max|param| * (m+n+1): the largest DP magnitude a pair can reach."""
    if mode == "edit":
        mx = max(1, abs(p.mismatch))
    else:
        mx = max(abs(p.match), abs(p.mismatch), abs(p.gap_open),
                 abs(p.gap_extend), abs(p.jump))
    return mx * (m + n + 1)


def f32_exact(p, m: int, n: int, mode: str = "global") -> bool:
    """True when every DP value for this (params, lengths) combination is
    an integer representable exactly in float32."""
    return dp_bound(p, m, n, mode) < F32_EXACT_LIMIT


def check_f32_exact(p, m: int, n: int, mode: str = "global") -> None:
    """Raise when the f32 fills would lose integer exactness: the
    reference computes in double (alignment.h:37-48). The batch path
    refuses such a pair, as the JAX batch path does; ``api.align_pair``
    takes the double instances instead."""
    if not f32_exact(p, m, n, mode):
        raise ValueError(
            f"scoring params x sequence lengths exceed the float32 "
            f"exact-integer range (max|param| * (m+n+1) >= 2^24 for "
            f"m={m}, n={n}); the batch path refuses such a pair, as "
            f"aligntools batch does (a single pair through align_pair or "
            f"the per-mode commands runs in double precision)"
        )

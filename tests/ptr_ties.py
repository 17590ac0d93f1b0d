"""Inputs on which the flat pointer fill's start info ties, for the CPU tests
(tests/test_torch_ptr_ops.py, against the JAX package's Pallas kernel) and
the card tests (tests/test_torch_cuda.py and chip_smoke.py, kernel against
plain). numpy only: the card's machine has no jax.

The kernel latches each thread's start-info candidate in registers and
reduces them once after the last row (csrc/ptr_fill.cu); these pairs put
equal candidates in one strip, in neighbouring strips and on both sides of
the warp boundary of the n_pad 1,024 launch (64 threads, a strip of 16
columns, a warp of 512), where that reduction, not the plain version's
running row maximum, picks the winner. Sixteen pairs, m_pad 64; the
target's background is 'N', which matches no query char.

  0-2   local: q[:16] (the maximum 32 at row 16) and q[-16:] (at row 64)
        planted twice: q[:16] ending at columns 512 and 536 (the same row,
        across the warp boundary); q[-16:] at 506 and q[:16] at 556 (the
        later column at the earlier row wins); q[:16] at 506 and q[-16:] at
        556
  3-5   local: a query of 16 A's then C/G/T against 17 A's, so that the
        maximum 32 sits at two neighbouring columns of row 16: both in one
        strip (103, 104), in neighbouring strips (112, 113), across the
        warp boundary (512, 513)
  6-9   fit: the L pattern q[:-1] (its last row a vertical gap: L = 2m - 4)
        and the M pattern q[:24] + 'NNN' + q[24:] (M = 2m - 4) of
        tests/blocked_ties.py: L then M across the warp boundary (M wins
        the tie), M then L, M and M in one warp, L and L across it
  10    overlap: a bottom-row maximum of exactly 0 (at column 5), which
        the j = 0 zero candidate wins
  11    overlap: the bottom-row maximum 2 at columns 3 and 17, in
        neighbouring strips
  12-15 m = n = 1; m = 64, n = 1; two random ragged pairs

TIES maps each tie pair to its mode, the (a, b) the full pair gives, and
its two halves: the target columns (0-based) that blanking to 'N' leaves
one of the tied candidates alone, and the (a, b) of that half; the score
is the same in all three. PARAMS gives each mode's scores (overlap's gap
of 4 keeps the zero and tie pairs' paths the best ones).
"""

import numpy as np

B, M_PAD, N_PAD = 16, 64, 1024
N = ord("N")
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
# match, mismatch, gap open, gap extend, jump
PARAMS = {"global": [2, -3, -2, -1, -7], "local": [2, -3, -2, -1, -7],
          "fit": [2, -3, -2, -1, -7], "overlap": [2, -3, -4, -1, -7]}
K = 16  # local pattern length
H = 24  # the M pattern's gap row
# pair -> (mode, (a, b) of the pair, ((blanked columns, (a, b)) x 2))
TIES = {
    0: ("local", (16, 512), ((range(520, 536), (16, 512)),
                             (range(496, 512), (16, 536)))),
    1: ("local", (16, 556), ((range(540, 556), (64, 506)),
                             (range(490, 506), (16, 556)))),
    2: ("local", (16, 506), ((range(540, 556), (16, 506)),
                             (range(490, 506), (64, 556)))),
    3: ("local", (16, 103), ((range(87, 88), (16, 104)),
                             (range(103, 104), (16, 103)))),
    4: ("local", (16, 112), ((range(96, 97), (16, 113)),
                             (range(112, 113), (16, 112)))),
    5: ("local", (16, 512), ((range(496, 497), (16, 513)),
                             (range(512, 513), (16, 512)))),
    6: ("fit", (0, 600), ((range(533, 600), (1, 400)),
                          (range(337, 400), (0, 600)))),
    7: ("fit", (0, 400), ((range(537, 600), (0, 400)),
                          (range(333, 400), (1, 600)))),
    8: ("fit", (0, 100), ((range(113, 180), (0, 100)),
                          (range(33, 100), (0, 180)))),
    9: ("fit", (1, 400), ((range(537, 600), (1, 400)),
                          (range(337, 400), (1, 600)))),
    11: ("overlap", (3, 0), ()),
}
ZERO_PAIR = 10  # overlap: the bottom row's maximum is 0, at column 5
OV_TIE_COLUMNS = (3, 17)  # pair 11's bottom-row maxima
# the overlap pairs' queries and target prefixes (a searched design: their
# paths are the best ones under PARAMS["overlap"])
OV_QUERY = {
    10: b"GTATCGGCTACCGCAAAAATAGTACCCTATTTACGCGGGATGTCCTAACGATCAGTTTTAACGT",
    11: b"CCGGGTGACATTGGAAGTGTCCGCAATCCATGGGAGGAGGTTCATGTTGACTATAGGTCCAGCT",
}
OV_TARGET = {10: b"NNCGT", 11: b"ACTAAATGGCTACACC"}


def _chars(s):
    return np.frombuffer(s, dtype=np.uint8).astype(np.int32)


def _plant(t, pat, end):
    """Put ``pat`` so that its last char sits at column ``end`` (1-based)."""
    t[end - len(pat) : end] = pat


def tie_inputs(seed=0):
    """(qs, ts, allow, ns, ms) in the kernels' int32 layout (query pad -1,
    target pad -2); allow is all ones."""
    rng = np.random.default_rng(seed)
    qs = np.full((B, M_PAD), -1, np.int32)
    ts = np.full((B, N_PAD), N, np.int32)
    ms = np.full(B, M_PAD)
    ns = np.full(B, N_PAD)
    for k in range(B):
        q = rng.choice(ALPHA, M_PAD)
        while q[-1] == q[-2]:  # else M would tie L inside the L pattern
            q[-1] = rng.choice(ALPHA)
        t = ts[k]
        if k in (0, 1, 2):
            first, last = q[:K], q[M_PAD - K:]
            for pat, end in {0: ((first, 512), (first, 536)),
                             1: ((last, 506), (first, 556)),
                             2: ((first, 506), (last, 556))}[k]:
                _plant(t, pat, end)
        elif k in (3, 4, 5):
            q[:K] = ord("A")
            q[K:] = rng.choice(_chars(b"CGT"), M_PAD - K)
            _plant(t, np.full(K + 1, ord("A")), {3: 104, 4: 113, 5: 513}[k])
        elif k in (6, 7, 8, 9):
            fit_l = q[: M_PAD - 1]
            fit_m = np.concatenate([q[:H], [N] * 3, q[H:]])
            for pat, end in {6: ((fit_l, 400), (fit_m, 600)),
                             7: ((fit_m, 400), (fit_l, 600)),
                             8: ((fit_m, 100), (fit_m, 180)),
                             9: ((fit_l, 400), (fit_l, 600))}[k]:
                _plant(t, pat, end)
        elif k in OV_QUERY:
            q = _chars(OV_QUERY[k])
            pre = _chars(OV_TARGET[k])
            t[: len(pre)] = pre
        else:
            t[:] = rng.choice(ALPHA, N_PAD)
            if k == 12:
                ms[k], ns[k] = 1, 1
            elif k == 13:
                ns[k] = 1
            else:
                ms[k] = rng.integers(1, M_PAD + 1)
                ns[k] = rng.integers(ms[k], N_PAD + 1)
            t[ns[k]:] = -2
            q[ms[k]:] = -1
        qs[k] = q
    allow = np.ones((B, N_PAD), np.float32)
    return (qs, ts, allow, ns[:, None].astype(np.int32),
            ms[:, None].astype(np.int32))


def pmat(mode):
    """The (1, 8) float32 params of ``mode``."""
    pm = np.zeros((1, 8), np.float32)
    pm[0, :5] = PARAMS[mode]
    return pm


def half(arrs, pair, which):
    """``arrs`` with half ``which`` (0 or 1) of tie pair ``pair``'s target
    blanked to 'N'."""
    qs, ts, *rest = arrs
    ts = ts.copy()
    ts[pair, list(TIES[pair][2][which][0])] = N
    return (qs, ts, *rest)


def overlap_bottom_row(q, t, n, pm):
    """Overlap's row m over columns 1..n-1, by a direct recurrence (M(i, 0)
    = 0, M(0, j) = -inf; diagonal, then the vertical and horizontal gaps of
    o each)."""
    match, mis, o = (float(x) for x in pm[0, :3])
    m = int((q >= 0).sum())
    prev = np.full(n + 1, -np.inf)
    prev[0] = 0.0
    for i in range(1, m + 1):
        cur = np.full(n + 1, -np.inf)
        cur[0] = 0.0
        dr = np.maximum(prev[:-1] + np.where(t[:n] == q[i - 1], match, mis),
                        prev[1:] + o)
        for j in range(1, n + 1):
            cur[j] = max(cur[j - 1] + o, dr[j - 1])
        prev = cur
    return prev[1:n]

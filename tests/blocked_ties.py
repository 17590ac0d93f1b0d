"""Inputs on which the blocked fills' start-info candidates tie across
column blocks, for the CPU tests (tests/test_torch_blocked.py, against the
JAX package's Pallas kernels) and the card tests (tests/test_torch_cuda.py,
kernel against plain). numpy only: the card's machine has no jax.

Sixteen pairs over four column blocks of ``c_blk`` columns, m_pad 64. The
target's background is 'N', which matches no query char, so a score comes
only from the segments of the query planted in it; each pattern sits 20
columns into its block.

  0-2   local: q[:16] and q[-16:] planted in blocks 0 and 2 (the local
        maximum 32 ends at row 16 and at row 64): block 0 at the smaller
        row (0), block 2 at the smaller row (1), the same row in both (2)
  3-6   fit (gap open -2): the L pattern q[:-1] (its last row ends in a
        vertical gap: L = 2m - 4, M at most 2m - 5) and the M pattern
        q[:24] + 'NNN' + q[24:] (a three-column gap: M = 2m - 4, L at most
        2m - 8) in blocks 0 and 2: L then M (3), M then L (4), M and M
        (5), L and L (6)
  7-12  random pairs whose n is a block edge or one past it: c_blk,
        c_blk + 1, 2 c_blk, 2 c_blk + 1, 3 c_blk + 1, 4 c_blk
  13-15 random ragged pairs

TIES maps each tie pair to its mode, the block whose candidate the merge
keeps, and what block 0's and block 2's candidates hold besides their equal
score: the row (local) or the matrix (fit: 0 M, 1 L). ``solo`` blanks one
of a tie pair's two patterns, so that each block's candidate can be read
alone.
"""

import numpy as np

B, M_PAD, BLOCKS = 16, 64, 4
K_LOCAL, H_FIT, OFFSET = 16, 24, 20
N = ord("N")
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
# pair -> (mode, block of the candidate the merge keeps, (block 0's row or
# matrix, block 2's))
TIES = {0: ("local", 0, (16, 64)), 1: ("local", 2, (64, 16)),
        2: ("local", 0, (16, 16)), 3: ("fit", 2, (1, 0)),
        4: ("fit", 0, (0, 1)), 5: ("fit", 0, (0, 0)), 6: ("fit", 0, (1, 1))}
EDGE_PAIRS = range(7, 13)
# match, mismatch, gap open, gap extend, jump
PARAMS = [2, -3, -2, -1, -7]


def _patterns(q):
    m = len(q)
    local = (q[:K_LOCAL], q[m - K_LOCAL:])
    fit_l = q[: m - 1]
    fit_m = np.concatenate([q[:H_FIT], [N] * 3, q[H_FIT:]])
    return {0: local, 1: local[::-1], 2: (local[0], local[0]),
            3: (fit_l, fit_m), 4: (fit_m, fit_l), 5: (fit_m, fit_m),
            6: (fit_l, fit_l)}


def tie_inputs(c_blk, seed=0):
    """(qs, ts, allow, ns, ms, params) in the kernels' int32 layout (query
    pad -1, target pad -2), n_pad = 4 * c_blk."""
    rng = np.random.default_rng(seed)
    n_pad = BLOCKS * c_blk
    qs = np.full((B, M_PAD), -1, np.int32)
    ts = np.full((B, n_pad), -2, np.int32)
    ms = np.full(B, M_PAD)
    ns = np.full(B, n_pad)
    for k in range(B):
        q = rng.choice(ALPHA, M_PAD)
        while q[-1] == q[-2]:  # else M would tie L inside the L pattern
            q[-1] = rng.choice(ALPHA)
        if k in TIES:
            ts[k] = N
            for blk, pat in zip((0, 2), _patterns(q)[k]):
                lo = blk * c_blk + OFFSET
                ts[k, lo : lo + len(pat)] = pat
        else:
            if k in EDGE_PAIRS:
                ns[k] = [c_blk, c_blk + 1, 2 * c_blk, 2 * c_blk + 1,
                         3 * c_blk + 1, n_pad][k - EDGE_PAIRS[0]]
            else:
                ns[k] = rng.integers(1, n_pad + 1)
            ms[k] = rng.integers(1, M_PAD + 1)
            q[ms[k]:] = -1
            ts[k, : ns[k]] = rng.choice(ALPHA, ns[k])
        qs[k] = q
    allow = np.ones((B, n_pad), np.float32)
    pm = np.zeros((1, 8), np.float32)
    pm[0, :5] = PARAMS
    return (qs, ts, allow, ns[:, None].astype(np.int32),
            ms[:, None].astype(np.int32), pm)


def solo(arrs, c_blk, keep):
    """The tie pairs with the pattern of block 2 (keep=0) or of block 0
    (keep=2) blanked to 'N'."""
    qs, ts, *rest = arrs
    ts = ts.copy()
    gone = 2 if keep == 0 else 0
    for k in TIES:
        ts[k, gone * c_blk : (gone + 1) * c_blk] = N
    return (qs, ts, *rest)

"""Inputs on which the blocked pointer fill's start info ties at the strip
and warp edges inside a column block and across a block edge, for the CPU
tests (tests/test_torch_blocked_strips.py, against the JAX package's Pallas
kernel and rescan) and the card tests (tests/test_torch_cuda.py, kernel
against plain). numpy only: the card's machine has no jax.

The blocked pointer fill runs each column block on the flat fill's register
strips (csrc/blocked_fill.cu): at C_BLK 1,024 a block is 64 threads of 16
columns, two warps, the warp edge after the block's local column 512; each
thread latches its candidate, the block reduces them once after the last
row, and the blocks' candidates merge in block order. Sixteen pairs, m_pad
64, n_pad 2,048 (two blocks); the target's background is 'N', which
matches no query char.

  0-9   tests/ptr_ties.py's pairs 0-9 moved one block right (every planted
        column + C_BLK): in block 1 they sit at the strip and warp edges
        they sit at in the flat launch. Local: q[:16] twice in one row
        across the warp edge; the later column at the earlier row; the
        maximum at neighbouring columns in one strip, in neighbouring
        strips, across the warp edge. Fit: the L and M patterns across the
        warp edge (both orders), M and M in one warp, L and L across it
  10-11 ptr_ties' overlap pairs, in block 0 (the dovetail needs the
        target's first columns): a bottom-row maximum of 0 that the j = 0
        candidate wins; the maximum at columns 3 and 17 (neighbouring
        strips)
  12    local: 17 A's ending at column C_BLK + 1, so that the maximum 32 sits
        at columns C_BLK and C_BLK + 1, across the block edge (the earlier
        block keeps it)
  13    local: q[-16:] ending at column C_BLK (block 0's last strip, row 64)
        and q[:16] at C_BLK + 16 (block 1's first strip, row 16): the later
        block wins on the smaller row
  14    fit: the L pattern ending at column C_BLK (block 0's last column)
        and the M pattern at C_BLK + 80: the later block's M wins the tie
  15    a random ragged pair across both blocks

TIES maps each tie pair to its mode, the (a, b) the full pair gives and
its two halves: the target columns (0-based) whose blanking to 'N' leaves
one of the tied candidates alone, and that half's (a, b); the score is the
same in all three.
"""

import numpy as np
import ptr_ties

B, M_PAD, C_BLK = 16, 64, 1024
N_PAD = 2 * C_BLK
N = ord("N")
MOVED = range(10)  # ptr_ties' pairs moved into block 1
OVERLAP = (10, 11)
K, H = ptr_ties.K, ptr_ties.H
FIT_M_END = C_BLK + 80


def _moved(k):
    mode, ab, halves = ptr_ties.TIES[k]
    shift = lambda x: (x[0], x[1] + C_BLK)
    return (mode, shift(ab), tuple((range(r.start + C_BLK, r.stop + C_BLK),
                                    shift(h)) for r, h in halves))


TIES = {k: _moved(k) for k in MOVED}
TIES[11] = ptr_ties.TIES[11]
TIES.update({
    12: ("local", (K, C_BLK), ((range(C_BLK - 16, C_BLK - 15),
                                (K, C_BLK + 1)),
                               (range(C_BLK, C_BLK + 1), (K, C_BLK)))),
    13: ("local", (K, C_BLK + K), ((range(C_BLK - K, C_BLK), (K, C_BLK + K)),
                                   (range(C_BLK, C_BLK + K),
                                    (M_PAD, C_BLK)))),
    14: ("fit", (0, FIT_M_END), ((range(C_BLK - M_PAD + 1, C_BLK),
                                  (0, FIT_M_END)),
                                 (range(FIT_M_END - M_PAD - 3, FIT_M_END),
                                  (1, C_BLK)))),
})
PARAMS = ptr_ties.PARAMS
pmat = ptr_ties.pmat


def tie_inputs(seed=0):
    """(qs, ts, allow, ns, ms) in the kernels' int32 layout (query pad -1,
    target pad -2); allow is all ones."""
    rng = np.random.default_rng(seed + 1)
    qs, ts0, _, _, ms = ptr_ties.tie_inputs(seed)
    ms = ms.copy()
    ts = np.full((B, N_PAD), N, np.int32)
    ns = np.full((B, 1), N_PAD, np.int32)
    for k in MOVED:
        ts[k, C_BLK:] = ts0[k]
    for k in OVERLAP:
        ts[k, : ptr_ties.N_PAD] = ts0[k]
    for k in (12, 13, 14):
        q = rng.choice(ptr_ties.ALPHA, M_PAD)
        while q[-1] == q[-2]:  # else M would tie L inside the L pattern
            q[-1] = rng.choice(ptr_ties.ALPHA)
        t = ts[k]
        if k == 12:
            q[:K] = ord("A")
            q[K:] = rng.choice(ptr_ties._chars(b"CGT"), M_PAD - K)
            ptr_ties._plant(t, np.full(K + 1, ord("A")), C_BLK + 1)
        elif k == 13:
            ptr_ties._plant(t, q[M_PAD - K:], C_BLK)
            ptr_ties._plant(t, q[:K], C_BLK + K)
        else:
            ptr_ties._plant(t, q[: M_PAD - 1], C_BLK)
            ptr_ties._plant(t, np.concatenate([q[:H], [N] * 3, q[H:]]),
                            FIT_M_END)
        qs[k] = q
        ms[k] = M_PAD
    q = rng.choice(ptr_ties.ALPHA, M_PAD)
    ms[15] = rng.integers(1, M_PAD + 1)
    ns[15] = rng.integers(C_BLK + 1, N_PAD + 1)
    q[ms[15, 0]:] = -1
    ts[15] = -2
    ts[15, : ns[15, 0]] = rng.choice(ptr_ties.ALPHA, ns[15, 0])
    qs[15] = q
    allow = np.ones((B, N_PAD), np.float32)
    return qs, ts, allow, ns, ms.astype(np.int32)


def half(arrs, pair, which):
    """``arrs`` with half ``which`` (0 or 1) of tie pair ``pair``'s target
    blanked to 'N'."""
    qs, ts, *rest = arrs
    ts = ts.copy()
    ts[pair, list(TIES[pair][2][which][0])] = N
    return (qs, ts, *rest)

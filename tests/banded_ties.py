"""Inputs on which the banded fill's start info ties, for the CPU tests
(tests/test_torch_banded_full.py, against the JAX package's banded
routes) and the card tests (tests/test_torch_cuda.py, kernel against
plain). numpy only: the card's machine has no jax.

The kernel latches each thread's start-info candidate and reduces them
once after the last row (csrc/banded_fill.cu), across the lanes of one
warp on the warp path and across the warps of a CTA beyond it. These
pairs put equal candidates on both sides of a thread's strip edge, of a
warp edge (where the launch has one) and at the band's last lane, and the
end cell (m, n) on a strip edge and on the band's last lane, for a given
band (96 or wider) and launch (``strip`` lanes a thread, ``warp_lanes``
lanes a warp). Twelve pairs, m_pad 64; the target's background is 'N', which matches no
query char. Lane k of row i holds column j = i - W + k.

  0  local: 16 A's at query rows 33-48 (the rest C/G/T) against a run of
     17 A's in the target, so the maximum 32 sits at row 48 on the two
     lanes of a strip edge: the smaller column wins
  1  local: the same across a warp edge (the warp path has one warp: the
     last strip edge inside the band)
  2  local: q[8:24] and q[40:56] planted (the maximum 32 at rows 24 and
     56), the first at the later column: the earlier row wins
  3  fit: the whole query planted twice, ending on a strip edge's lane and
     64 lanes further on (M = 128 twice on row 64): the smaller column
  4  fit: the L pattern q[:-1] (its last row a vertical gap, L = 124) then
     the M pattern q[:24] + 'NNN' + q[24:] (M = 124): M wins the tie
  5  overlap: the bottom-row maximum 2 at columns 3 and 17
     (tests/ptr_ties.py's searched pair), in neighbouring strips of narrow
     launches
  6  global: the end cell on a strip edge's lane
  7  global: the end cell on the band's last lane (n = m + W)
  8-11 m = n = 1; m = 64, n = 1; two random ragged pairs within the band

TIES maps the designed pairs to their mode and the (a, b) that they give.
PARAMS gives each mode's scores (tests/ptr_ties.py's).
"""

import numpy as np

import ptr_ties

B, M_PAD = 12, 64
K = 16
N = ord("N")
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
CGT = np.frombuffer(b"CGT", dtype=np.uint8).astype(np.int32)
PARAMS = ptr_ties.PARAMS
H = ptr_ties.H  # the M pattern's gap row


def _edge_lane(lo, hi, step):
    """The first lane k >= lo with k + 1 a multiple of ``step`` (the last
    lane before an edge) and k + 1 < hi."""
    k = max(lo, step - 1)
    k += (-(k + 1)) % step
    assert k + 1 < hi, (lo, hi, step)
    return k


def layout(band, strip, warp_lanes):
    """The designed pairs' lanes and columns at this band and launch:
    {pair: (mode, (a, b), n, plants)} with plants a list of (query slice
    or pattern, last target column)."""
    W, V = band, 2 * band + 1
    m = M_PAD
    out = {}
    # 0, 1: local, row 48, lanes (k, k + 1) over a strip / warp edge
    i = 48
    lo = K - i + W  # the run of 17 needs column j - 16 >= 1
    k0 = _edge_lane(lo, V, strip)
    if warp_lanes < V:  # a warp edge
        k1 = _edge_lane(lo, V, warp_lanes)
    else:  # the last strip edge inside the band
        k1 = (V - 1) // strip * strip - 1
    for pair, k in ((0, k0), (1, k1)):
        j = i - W + k
        out[pair] = ("local", (i, j), j + 8, [("A17", j + 1)])
    # 2: q[8:24] ending at (24, jA) and q[40:56] at (56, jB), jA > jB
    jb = max(K, 56 - W + _edge_lane(max(0, K - 56 + W), V, strip))
    ja = jb + 20
    out[2] = ("local", (24, ja), ja + 8, [((8, 24), ja), ((40, 56), jb)])
    # 3: the query twice on row 64, 64 lanes apart
    k3 = _edge_lane(W, V - m, strip)  # j3 >= m, and j3 + m inside the band
    j3 = m - W + k3
    out[3] = ("fit", (0, j3), j3 + m + 4, [((0, m), j3), ((0, m), j3 + m)])
    # 4: L pattern then M pattern
    jl = m - 1  # columns 1..63; the M pattern's 67 then end in the band
    jm = jl + m + 3
    out[4] = ("fit", (0, jm), jm + 4, [("L", jl), ("M", jm)])
    # 5: tests/ptr_ties.py's overlap tie, columns 3 and 17
    out[5] = ("overlap", (3, 0), 24, [("OV", 0)])
    # 6, 7: the end cell on a strip edge, on the band's last lane
    k6 = _edge_lane(W, V, strip)
    out[6] = ("global", None, m - W + k6, [])
    out[7] = ("global", None, m + W, [])
    return out


def tie_inputs(band, strip, warp_lanes, seed=0):
    """(qs, te, ns, ms) in the banded kernel's int32 layout (query pad -1;
    te the target after ``band`` pad columns, pad -2), and TIES: {pair:
    (mode, (a, b))} for the designed pairs."""
    rng = np.random.default_rng(seed)
    W, V = band, 2 * band + 1
    lay = layout(band, strip, warp_lanes)
    n_max = max(max(n for _, _, n, _ in lay.values()), M_PAD)
    qs = np.full((B, M_PAD), -1, np.int32)
    te = np.full((B, W + n_max + V + 1), -2, np.int32)
    ms = np.full(B, M_PAD)
    ns = np.zeros(B, np.int64)
    ties = {}
    for k in range(B):
        q = rng.choice(ALPHA, M_PAD)
        if k in lay:
            mode, ab, n, plants = lay[k]
            t = np.full(n, N, np.int32)
            if k in (0, 1):
                q = rng.choice(CGT, M_PAD)
                q[32:48] = ord("A")
            if k == 4:
                while q[-1] == q[-2]:  # else M would tie L inside the L pattern
                    q[-1] = rng.choice(ALPHA)
            if k == 5:
                q = ptr_ties._chars(ptr_ties.OV_QUERY[11])
            if mode == "global":
                t = q[: min(n, M_PAD)].copy()
                t = np.concatenate([t, rng.choice(ALPHA, max(0, n - M_PAD))])
                mut = rng.random(n) < 0.1
                t[mut] = rng.choice(ALPHA, int(mut.sum()))
            for pat, end in plants:
                if pat == "A17":
                    pat = np.full(K + 1, ord("A"))
                elif pat == "L":
                    pat = q[: M_PAD - 1]
                elif pat == "M":
                    pat = np.concatenate([q[:H], [N] * 3, q[H:]])
                elif pat == "OV":
                    pre = ptr_ties._chars(ptr_ties.OV_TARGET[11])
                    t[: len(pre)] = pre
                    continue
                else:
                    pat = q[pat[0]:pat[1]]
                t[end - len(pat):end] = pat
            if ab is not None:
                ties[k] = (mode, ab)
        else:
            if k == 8:
                ms[k], n = 1, 1
            elif k == 9:
                n = 1
            else:
                ms[k] = rng.integers(1, M_PAD + 1)
                n = int(rng.integers(max(1, ms[k] - W), ms[k] + W + 1))
            t = rng.choice(ALPHA, n)
        ns[k] = len(t)
        q[ms[k]:] = -1
        qs[k] = q
        te[k, W : W + len(t)] = t
    return (qs, te, ns[:, None].astype(np.int32),
            ms[:, None].astype(np.int32)), ties


def pmat(mode):
    """The (1, 8) float32 params of ``mode``."""
    return ptr_ties.pmat(mode)

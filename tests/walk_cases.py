"""Walks drawn to cross the walk kernel's pointer tiles, for the CPU tests
(tests/test_torch_walk.py against the JAX package's device walks,
tests/test_torch_banded_full.py against its banded host walk) and the
card tests (tests/test_torch_cuda.py, kernel against plain). numpy only:
the card's machine has no jax.

A case is synthetic pointer bytes: random bytes, with a path drawn over
them from its start as runs of states (``draw``), so that every byte the
walk reads is set by the run it is in and every other byte is noise that a
read from the wrong cell (a wrong tile, a wrong shift) turns into another
path. The kernel stages tiles of 64 byte-rows x 128 columns (flat) and
whole window rows up to 512 lanes (``csrc/walk.cu``); the shapes below
are a few tiles of that in each direction.

  jrun     fit+jump rpb 1: J runs of 600 columns and of 990, to column 0,
           after which the walk goes on diagonally with j <= 0 (fit reads
           column 0) to row 0; an L run, a U run, and a walk of no steps
           (i = 0)
  runs     global and local at rpb 1 and 2: L runs up across byte-row
           tiles, U runs left across column tiles
  diag     global rpb 1 and 2, overlap rpb 1, 2 and 4: diagonal runs of 500
           rows, longer than a tile's rows at each rpb; overlap's end at
           j = 0 (nj == 0) and at row 0 (i <= 0 before j: its unset hazard,
           err bit 1, the step left out of the count)
  fitj0    fit rpb 1 and 2: diagonals from j = 100 on past column 0
  home     local rpb 1 and 2: a HOME code at cells on tile edges (rows 63,
           64, 127, 128; columns 127, 128, 255, 256; row 0; column 0)
  unset    global, fit (rpb 1 and 2) and overlap (rpb 1 and 4): an unset
           code after the walk crossed a tile (err bit 1)
  edges    global rpb 1 and 2: starts at columns 1, 16, 17, 128 and 129,
           at (1, 1) and with j = 0 (no step)
  window   global, local, fit and overlap at W 64, 128 and 300 (wider than
           whole-row tiles): diagonals across row tiles, L and U runs, and
           runs that leave the band (err bit 2)

``flat_cases()`` and ``window_cases()`` return ``Case``s; a window case
also carries its (q, t) byte pairs.
"""

import dataclasses

import numpy as np

LOW, MID, UPP, JUMP = 0, 1, 2, 3
HOME, UNSET = "home", "unset"
ALPHA = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
M_PAD, N_PAD = 512, 1024
# the bits of the rpb-1 byte / the rpb-2 nibble (aligntools_tpu_torch/layout.py)
BITS = {1: {"code": 0x7, LOW: 0x8, UPP: 0x10, JUMP: 0x20},
        2: {"code": 0x3, LOW: 0x4, UPP: 0x8}}
CODE = {1: {LOW: 0, MID: 1, UPP: 2, JUMP: 3, HOME: 4, UNSET: 7},
        2: {LOW: 0, MID: 1, UPP: 2, HOME: 3, UNSET: 3}}
# overlap's 2-bit codes, by the move they make
OV = {"left": 0, "diag": 1, "up": 2, UNSET: 3}


@dataclasses.dataclass
class Case:
    name: str
    mode: str
    rpb: int
    ptrs: np.ndarray  # (B, R, C) uint8
    qs: np.ndarray  # (B, m_pad) int32, pad -1
    ts: np.ndarray  # (B, n_pad) int32, pad -2 (window: the te plane)
    starts: np.ndarray  # (3, B) int32: state, i, j
    band: int | None = None
    pairs: list | None = None  # window: the (q, t) bytes


class Grid:
    """Pointer bytes of B pairs with a setter for one cell's fields."""

    def __init__(self, rng, B, m_pad, cols, rpb, window_band=None):
        self.rpb, self.band = rpb, window_band
        self.p = rng.integers(0, 256, (B, m_pad // rpb, cols)).astype(
            np.uint8)

    def _at(self, b, i, j):
        """(byte row, column, shift) of cell (i, j): row i-1 clamped at 0,
        column j-1 clamped into the row (window: lane j - i + band)."""
        row = max(i - 1, 0)
        cols = self.p.shape[2]
        col = (j - i + self.band if self.band is not None
               else min(max(j - 1, 0), cols - 1))
        assert 0 <= col < cols, (i, j)
        return row // self.rpb, col, (row % self.rpb) * (8 // self.rpb)

    def out(self, i, j):
        """Cell (i, j) lies outside a window's band."""
        return self.band is not None and not 0 <= j - i + self.band <= \
            2 * self.band

    def set(self, b, i, j, mask, value):
        r, c, sh = self._at(b, i, j)
        v = int(self.p[b, r, c])
        self.p[b, r, c] = (v & ~(mask << sh)) | ((value & mask) << sh)


def draw(grid, b, state, i, j, runs, end=None, mode="global"):
    """Draw runs of (state, steps) from (state, i, j): each cell a run
    reads sends the walk on in that run (or into the next run's state);
    ``end`` (HOME / UNSET) is written into the M code of the cell after the
    last run, which must end in MID. Returns the start."""
    rpb = grid.rpb
    bits, code = BITS[rpb], CODE[rpb]
    start = (state, i, j)
    flat = [s for s, n in runs for _ in range(n)]
    for k, s in enumerate(flat):
        assert s == state
        if grid.out(i, j):  # the walk leaves the band here
            return start
        nxt = flat[k + 1] if k + 1 < len(flat) else s
        if s == MID:
            grid.set(b, i, j, bits["code"], code[nxt])
        else:  # LOW's bit says "to MID", UPP's and JUMP's "stay"
            assert nxt in (s, MID)
            grid.set(b, i, j, bits[s],
                     bits[s] if (nxt == MID) == (s == LOW) else 0)
        if s in (LOW, MID):
            i -= 1
        if s != LOW:
            j -= 1
        state = nxt
        if i <= 0 or (j <= 0 and mode != "fit"):
            return start
    if end is not None:
        assert state == MID
        grid.set(b, i, j, bits["code"], code[end])
    return start


def draw_overlap(grid, b, i, j, runs, end=None):
    """Overlap's codes move directly: runs of ("diag" | "left" | "up",
    steps); ``end`` UNSET is written after the last run."""
    sh = 8 // grid.rpb
    for move, n in runs:
        for _ in range(n):
            if j <= 0 or i <= 0 or grid.out(i, j):
                return
            grid.set(b, i, j, (1 << sh) - 1 if sh < 8 else 0xFF, OV[move])
            i -= move != "left"
            j -= move != "up"
    if end is not None and j > 0:
        grid.set(b, i, j, 0x3, OV[end])


def _chars(rng, B, m_pad, n_pad, ms, ns):
    qs = np.full((B, m_pad), -1, np.int32)
    ts = np.full((B, n_pad), -2, np.int32)
    for k in range(B):
        qs[k, : ms[k]] = rng.choice(ALPHA, ms[k])
        ts[k, : ns[k]] = rng.choice(ALPHA, ns[k])
    return qs, ts


def _flat(name, mode, rpb, seed, walks, m_pad=M_PAD, n_pad=N_PAD):
    """A flat case from ``walks``: one callable a pair, drawing on the
    grid and returning its start."""
    rng = np.random.default_rng(seed)
    B = len(walks)
    grid = Grid(rng, B, m_pad, n_pad, rpb)
    starts = np.array([w(grid, b) for b, w in enumerate(walks)],
                      np.int32).T
    ms = np.full(B, m_pad)
    ns = np.full(B, n_pad)
    qs, ts = _chars(rng, B, m_pad, n_pad, ms, ns)
    return Case(name, mode, rpb, grid.p, qs, ts, np.ascontiguousarray(starts))


def _affine(state, i, j, runs, end=None, mode="global"):
    return lambda g, b: draw(g, b, state, i, j, runs, end, mode)


def _overlap(i, j, runs, end=None):
    def w(g, b):
        draw_overlap(g, b, i, j, runs, end)
        return (0, i, j)
    return w


def flat_cases():
    cases = [_flat("jrun", "fit", 1, 1, [
        _affine(MID, 500, 900, [(MID, 40), (JUMP, 600), (MID, 500)],
                mode="fit"),
        _affine(MID, 300, 1000, [(MID, 10), (JUMP, 990), (MID, 300)],
                mode="fit"),
        _affine(LOW, 480, 1000, [(LOW, 100), (MID, 50), (UPP, 300),
                                 (MID, 400)], mode="fit"),
        _affine(MID, 0, 700, [(MID, 1)], mode="fit"),
    ])]
    for mode in ("global", "local"):
        for rpb in (1, 2):
            cases.append(_flat(f"runs-{mode}", mode, rpb, 2 + rpb, [
                _affine(MID, 500, 1000, [(MID, 20), (LOW, 300), (MID, 30),
                                         (UPP, 400), (MID, 200)]),
                _affine(LOW, 511, 600, [(LOW, 200), (MID, 100), (LOW, 150),
                                        (MID, 100)]),
                _affine(UPP, 200, 1024, [(UPP, 700), (MID, 10), (UPP, 150),
                                         (MID, 300)]),
            ]))
    for rpb in (1, 2):
        cases.append(_flat("diag", "global", rpb, 5, [
            _affine(MID, 500, 1000, [(MID, 600)]),
            _affine(MID, 512, 512, [(MID, 600)]),
            _affine(MID, 300, 1024, [(MID, 40), (UPP, 90), (MID, 400)]),
        ]))
    for rpb in (1, 2, 4):
        cases.append(_flat("diag", "overlap", rpb, 6, [
            _overlap(500, 480, [("diag", 600)]),  # ends at j = 0
            _overlap(480, 1000, [("diag", 600)]),  # reaches row 0 first
            _overlap(512, 900, [("diag", 50), ("left", 300), ("up", 70),
                                ("diag", 600)]),
        ]))
    for rpb in (1, 2):
        cases.append(_flat("fitj0", "fit", rpb, 7, [
            _affine(MID, 400, 100, [(MID, 400)], mode="fit"),
            _affine(MID, 300, 1, [(MID, 300)], mode="fit"),
            _affine(LOW, 200, 0, [(LOW, 20), (MID, 200)], mode="fit"),
        ]))
    homes = [(63, 127), (64, 128), (127, 255), (128, 256), (0, 40), (30, 0)]
    for rpb in (1, 2):
        cases.append(_flat("home", "local", rpb, 8, [
            _affine(MID, r + 1 + d, c + 1 + d, [(MID, d)], HOME)
            for r, c in homes for d in (1, 150) if r + 1 + d <= M_PAD]))
    for mode, rpb in (("global", 1), ("global", 2), ("fit", 1), ("fit", 2)):
        cases.append(_flat("unset", mode, rpb, 9, [
            _affine(MID, 500, 1000, [(MID, 200)], UNSET, mode),
            _affine(MID, 400, 900, [(MID, 10), (UPP, 300), (MID, 5)],
                    UNSET, mode),
        ]))
    for rpb in (1, 4):
        cases.append(_flat("unset", "overlap", rpb, 10, [
            _overlap(500, 1000, [("diag", 300)], UNSET),
            _overlap(400, 900, [("left", 200), ("diag", 10)], UNSET),
        ]))
    for rpb in (1, 2):
        cases.append(_flat("edges", "global", rpb, 11, [
            _affine(MID, 300, j, [(MID, 300)]) for j in (1, 16, 17, 128, 129)
        ] + [_affine(MID, 1, 1, [(MID, 1)]), _affine(MID, 50, 0, [])]))
    return cases


def _window(name, mode, band, seed, walks, m_pad=384):
    """A window case: pairs of m = m_pad and n = m_pad + band // 2 (fit's
    n >= m), pointers (B, m_pad, lanes_padded(band)), te as the banded
    engine lays it out."""
    rng = np.random.default_rng(seed)
    B = len(walks)
    V = 2 * band + 1
    cols = -(-V // 16) * 16
    grid = Grid(rng, B, m_pad, cols, 1, band)
    starts = np.array([w(grid, b) for b, w in enumerate(walks)],
                      np.int32).T
    m, n = m_pad, m_pad + band // 2
    qs = np.full((B, m_pad), -1, np.int32)
    te = np.full((B, band + max(n, m_pad) + V + 1), -2, np.int32)
    pairs = []
    for k in range(B):
        q, t = rng.choice(ALPHA, m), rng.choice(ALPHA, n)
        qs[k, :m] = q
        te[k, band : band + n] = t
        pairs.append((q.astype(np.uint8).tobytes(),
                      t.astype(np.uint8).tobytes()))
    return Case(name, mode, 1, grid.p, qs, te, np.ascontiguousarray(starts),
                band, pairs)


def window_cases():
    cases = []
    for band in (64, 128, 300):
        m, n = 384, 384 + band // 2
        for mode in ("global", "local", "fit"):
            cases.append(_window(f"window-W{band}", mode, band, band, [
                # diagonals across the row tiles, short L and U runs in band
                _affine(MID, m, n, [(MID, 100), (LOW, band // 2), (MID, 60),
                                    (UPP, band), (MID, 400)], mode=mode),
                # an L run of 2W: the lane runs past 2W (err bit 2)
                _affine(MID, m - 5, n - 5, [(MID, 50), (LOW, 2 * band + 1)],
                        mode=mode),
                # a U run: the lane runs below 0
                _affine(UPP, m, n, [(UPP, 2 * band + 1)], mode=mode),
            ]))
        cases.append(_window(f"window-W{band}", "overlap", band, band + 1, [
            _overlap(m, n, [("diag", 150), ("left", band // 2),
                            ("diag", 400)]),
            _overlap(m, n, [("diag", 40), ("left", 2 * band + 1)]),
        ]))
    return cases

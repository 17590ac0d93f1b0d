"""Banded DP: the fill restricted to the diagonal band |j - i| <= W.

Port of ``aligntools_tpu/engine/banded.py``, with its entry points and one
keyword more, ``device`` ("cuda" by default, or "cpu"). For similar-length
pairs (read-vs-read alignment, consensus polishing) the optimal path stays
near the main diagonal, and a band of half-width W does O(m*W) work
instead of O(m*n): rows are kept in window coordinates (lane k = j - i + W
of a (2W+1)-lane window that slides one column a row).

One CUDA kernel (``ops/banded.py`` over ``csrc/banded_fill.cu``) takes the
place of both of the JAX package's routes, the vmapped XLA ``banded_fill``
and the Pallas ``_banded_kernel``, which give the same bits; so there is no
``engine`` knob. Rows come from the pointer-emitting fill and the device
walk in window coordinates (``device_tb.walk(..., band=W)``), collected in
two device-to-host copies a wave, as the flat rows path collects them.

Results do not depend on how pairs are padded or grouped: rows past a
pair's m are -inf, and target reads past its n are pads. So pairs are
grouped by query length (``GROUPS``) to cut padded rows, and a group's
pointer tensor, the only O(B*m*V) allocation, is sliced to the rows path's
device-memory budget (``batch.PTR_BUDGET_FRAC``), with the fill's scratch
beside it past the kernel's one-pass width (``ops/banded.scratch_bytes``).
Every band runs; only that budget refuses a slab.

Semantics are the JAX banded routes', empty sequences included: a pair
with m = 0 or n = 0 runs through the fill like any other (global, local,
overlap and fit score -inf there, edit +inf; global's rows are gaps
against the other side; fit has no finite traceback start), which differs
from the unbanded engines' borders (``batch._empty_result``).

Reference recurrences: src/alignment.h:417-473 (global), 805-847 (local),
291-315 (edit), 596-694 (fit, sans jump), 926-964 (overlap).
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from aligntools_tpu_torch import batch
from aligntools_tpu_torch.backend import resolve_device
from aligntools_tpu_torch.convert import params_matrix
from aligntools_tpu_torch.engine import device_tb
from aligntools_tpu_torch.exact import check_f32_exact
from aligntools_tpu_torch.ops import banded as kern
from aligntools_tpu_torch.params import AlignParams, AlignResult

BANDED_MODES = ("global", "local", "edit", "fit", "overlap")
TRACEBACK_MODES = ("global", "local", "fit", "overlap")

# pairs sorted by query length are cut into at most GROUPS groups of at
# least GROUP_PAIRS_MIN pairs (enough CTAs to fill the card), each padded
# to its own longest query
GROUPS = 8
GROUP_PAIRS_MIN = 1024


def band_certificate(
    mode: str, m: int, n: int, band: int, params: AlignParams = AlignParams()
) -> float:
    """Bound on every alignment path that uses ANY cell outside the band.

    Copied from ``aligntools_tpu/engine/banded.py`` (that module imports
    jax). Max-plus modes return an UPPER bound: if the banded score >= this
    value, no out-of-band path can strictly beat it, so the banded score is
    provably the exact unbanded score. Edit (min-plus) returns a LOWER
    bound on out-of-band cost: banded distance <= bound certifies.

    A path that touches diagonal offset |j - i| = band+1 must contain
    >= band+1 gap steps, and its match/mismatch columns P satisfy
    P <= min(m, n-band-1) (right crossing) / min(n, m-band-1) (left). For
    global and edit every out-of-band path must cross, so the bound bites;
    local, fit and overlap admit paths that live entirely beyond the band
    with zero gaps, so the bound degrades to the perfect-score ceiling. Gap
    params must be non-positive for the max-plus bound (else +inf = never
    certified).
    """
    c = max(params.match, params.mismatch)  # best per aligned column
    cpos = max(c, 0.0)
    if mode == "edit":
        # cost >= I + D + u*P with indel 1, u = params.mismatch quirk
        u_neg = min(params.mismatch, 0.0)
        w1 = band + 1
        sides = []
        if n >= w1:  # right: I >= W+1, D >= I - (n-m), P <= min(m, n-W-1)
            sides.append(
                w1 + max(0.0, w1 - (n - m)) + u_neg * max(min(m, n - w1), 0)
            )
        if m >= w1:  # left: D >= W+1, I = D + (n-m)
            sides.append(
                w1 + max(0.0, w1 + (n - m)) + u_neg * max(min(n, m - w1), 0)
            )
        return min(sides) if sides else float("inf")
    o, e = float(params.gap_open), float(params.gap_extend)
    if mode == "overlap":
        e = 0.0  # linear gap o; -e is dead (alignment.h:944)
    if o > 0 or e > 0:
        return float("inf")
    if mode == "global":
        w1 = band + 1
        sides = []
        if n >= w1:
            sides.append(cpos * max(min(m, n - w1), 0) + o + e * w1)
        if m >= w1:
            sides.append(cpos * max(min(n, m - w1), 0) + o + e * w1)
        return max(sides) if sides else float("-inf")
    if mode == "fit":  # all of q consumed: P <= m, gaps <= 0
        return cpos * m
    return cpos * min(m, n)  # local / overlap


@dataclasses.dataclass
class _Slab:
    idx: list  # positions in the caller's pairs
    m_pad: int
    q: np.ndarray  # (B, m_pad) uint8, 0 pad
    t: np.ndarray  # (B, n_max) uint8, 0 pad
    m: np.ndarray  # (B,) int32
    n: np.ndarray


def _groups(pairs):
    """Positions of ``pairs`` sorted by query length, cut into groups."""
    order = sorted(range(len(pairs)), key=lambda k: len(pairs[k][0]))
    size = max(GROUP_PAIRS_MIN, -(-len(order) // GROUPS))
    return [order[lo : lo + size] for lo in range(0, len(order), size)]


def _m_pad(idx, pairs):
    return -(-max(max(len(pairs[k][0]) for k in idx), 1) // 16) * 16


def _slab_bytes(m_pad, band):
    """A pair's device bytes in a rows slab: its (m_pad, V_pad) pointers
    and the fill's scratch (0 up to the kernel's one-pass width)."""
    return m_pad * kern.lanes_padded(band) + kern.scratch_bytes(band)


def plan(pairs, band, budget=None):
    """The slabs a run fills, as (positions, m_pad): the groups, each cut
    into equal slices whose (B, m_pad, V_pad) pointer bytes and fill
    scratch stay within ``budget`` (no cut without one)."""
    out = []
    for idx in _groups(pairs):
        m_pad = _m_pad(idx, pairs)
        step = len(idx)
        if budget is not None:
            bytes_pp = _slab_bytes(m_pad, band)
            cap = budget // bytes_pp
            if cap == 0:
                raise ValueError(
                    f"a pair's {bytes_pp} banded pointer and scratch bytes "
                    f"({m_pad} rows x {kern.lanes_padded(band)} lanes) "
                    f"exceed the device budget of {budget}")
            step = -(-step // -(-step // cap))  # equal slices of <= cap
        out += [(idx[lo : lo + step], m_pad)
                for lo in range(0, len(idx), step)]
    return out


def _slab(idx, pairs, m_pad):
    B = len(idx)
    n_max = max(max(len(pairs[k][1]) for k in idx), 1)
    s = _Slab(list(idx), m_pad, np.zeros((B, m_pad), np.uint8),
              np.zeros((B, n_max), np.uint8), np.zeros(B, np.int32),
              np.zeros(B, np.int32))
    for r, k in enumerate(idx):
        q, t = pairs[k]
        s.q[r, : len(q)] = np.frombuffer(q, np.uint8)
        s.t[r, : len(t)] = np.frombuffer(t, np.uint8)
        s.m[r], s.n[r] = len(q), len(t)
    return s


def _slab_tensors(s, band, device):
    """(qs, te, ns, ms) on ``device`` in the kernel's layout: query pad -1;
    te the target after ``band`` pad columns, pad -2, wide enough that no
    row's window is clipped."""
    ms = batch._to_device(s.m, device)
    ns = batch._to_device(s.n, device)
    qs, ts = batch._sentinelize(batch._to_device(s.q, device),
                                batch._to_device(s.t, device), ms, ns)
    V = 2 * band + 1
    n_ext = band + max(ts.shape[1], s.m_pad) + V + 1
    te = torch.full((len(s.idx), n_ext), -2, dtype=torch.int32,
                    device=device)
    te[:, band : band + ts.shape[1]] = ts
    return qs, te, ns[:, None], ms[:, None]


def banded_batch_scores(
    mode: str,
    pairs,
    band: int,
    params: AlignParams = AlignParams(),
    *,
    device="cuda",
    counters=None,
):
    """Batched banded scores. Returns (scores, edge_best) float64 arrays,
    edit's distances among them (+inf where no in-band path exists)."""
    if not pairs:
        raise ValueError("max() arg is an empty sequence: no pairs")
    if mode not in BANDED_MODES:
        raise ValueError(f"banded engine covers {BANDED_MODES}")
    for q, t in pairs:
        if mode in ("global", "edit") and abs(len(t) - len(q)) > band:
            raise ValueError("band cannot contain the end cell")
        if mode == "fit" and len(q) > len(t):
            raise ValueError("first sequence must be shorter than the second")
    check_f32_exact(params, max(len(q) + len(t) for q, t in pairs), 0, mode)
    device = resolve_device(device)
    pmat = params_matrix(params, device)
    t0 = time.perf_counter()
    outs = []
    for idx, m_pad in plan(pairs, band):
        s = _slab(idx, pairs, m_pad)
        outs.append((s.idx, torch.stack(kern.banded_scores(
            mode, band, *_slab_tensors(s, band, device), pmat))))
    t0 = batch._tick(counters, "encode_seconds", t0)
    # ONE device->host pull for every group
    flat = torch.cat([o.reshape(-1) for _, o in outs]).cpu().numpy()
    scores = np.empty(len(pairs), np.float64)
    edges = np.empty(len(pairs), np.float64)
    off = 0
    for idx, o in outs:
        B = len(idx)
        scores[idx] = flat[off : off + B]
        edges[idx] = flat[off + B : off + 2 * B]
        off += 2 * B
    batch._tick(counters, "fill_seconds", t0)
    return scores, edges


def banded_score(
    mode: str,
    q: bytes,
    t: bytes,
    band: int,
    params: AlignParams = AlignParams(),
    *,
    device="cuda",
):
    """Banded score for one pair; returns (score, edge_best). Raises if the
    end cell cannot be in band (|n - m| > band)."""
    if mode not in BANDED_MODES:
        raise ValueError(f"banded engine covers {BANDED_MODES}")
    m, n = len(q), len(t)
    if mode in ("global", "edit") and abs(n - m) > band:
        raise ValueError(
            f"band {band} cannot contain the end cell (|n-m|={abs(n - m)})"
        )
    if mode == "fit" and m > n:
        raise ValueError("first sequence must be shorter than the second")
    score, edge = banded_batch_scores(mode, [(q, t)], band, params,
                                      device=device)
    return float(score[0]), float(edge[0])


def banded_score_auto(
    mode: str,
    q: bytes,
    t: bytes,
    params: AlignParams = AlignParams(),
    band0: int | None = None,
    *,
    device="cuda",
):
    """Score with band doubling; returns ``(score, band, certified)``.

    ``certified=True`` means the score is provably the exact unbanded
    score: ``band_certificate`` discharged it, or the band covered the whole
    matrix. While uncertified the band keeps doubling even when the score
    plateaus: a plateau alone can be wrong."""
    m, n = len(q), len(t)
    band = band0 if band0 is not None else max(32, abs(n - m) + 16)
    while True:
        band = min(band, max(m, n))
        score, _ = banded_score(mode, q, t, band, params, device=device)
        cert = band_certificate(mode, m, n, band, params)
        if mode == "edit":
            if score <= cert:
                return score, band, True
        elif score >= cert:
            return score, band, True
        if band >= max(m, n):
            return score, band, True  # band covers the whole matrix
        band *= 2


# ---------------------------------------------------------------------------
# Rows: pointer-emitting fill + window walk, slabs under the pointer budget
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _PendingRows:
    idx: list
    cols1: torch.Tensor  # (n_steps, B) uint8
    cols2: torch.Tensor
    scal: torch.Tensor  # (6, B) int32: count, fi, fj, err, score, edge bits


def _dispatch_rows(mode, s, band, pmat, device):
    """Launch one slab's pointer fill and walk without syncing."""
    qs, te, ns, ms = _slab_tensors(s, band, device)
    best, edge, a, b, ptrs = kern.banded_full(mode, band, qs, te, ns, ms,
                                              pmat)
    starts = device_tb.walk_starts(mode, best, a, b, ms, ns)
    # on the walk stream, under the next slab's fill (batch.py's rows note)
    cols1, cols2, scal = device_tb.walk_behind(
        mode, 1, ptrs, qs, te, starts,
        ride=(best.view(torch.int32), edge.view(torch.int32)), band=band)
    return _PendingRows(s.idx, cols1, cols2, scal)


def _collect(mode, pends, pairs, out):
    """Two device->host copies for a wave: the scalars, then the walked
    columns; fills ``out`` (position -> (score, edge, err, rows))."""
    if not pends:
        return
    device_tb.join_walks(pends[0].scal.device)
    scals = device_tb.walk_scalars_many([p.scal for p in pends])
    clean = []
    for sc in scals:
        sc = sc.copy()
        sc[3] = 0  # errors are raised later, in the caller's pair order
        clean.append(sc)
    rows_list = device_tb.walk_rows_many(
        mode, [(p.cols1, p.cols2) for p in pends], clean,
        [[pairs[k] for k in p.idx] for p in pends])
    for p, sc, rows in zip(pends, scals, rows_list):
        score, edge = sc[4].view(np.float32), sc[5].view(np.float32)
        for r, k in enumerate(p.idx):
            out[k] = (float(score[r]), float(edge[r]), int(sc[3][r]), rows[r])


def _walk_error(mode, err):
    if mode == "overlap":
        return RuntimeError("banded overlap traceback hit the reference's "
                            "unset-pointer hazard")
    if err & device_tb.ERR_LEFT_BAND:
        return RuntimeError("banded traceback left the band")
    return RuntimeError("traceback hit unset M pointer")


def banded_align_batch(
    mode: str,
    pairs,
    band: int,
    params: AlignParams = AlignParams(),
    *,
    device="cuda",
    counters=None,
):
    """Batched banded alignments WITH rows; returns ([AlignResult],
    edge_best array). Rows are an optimal in-band alignment, byte for byte
    the JAX package's banded rows."""
    if mode not in TRACEBACK_MODES:
        raise ValueError("banded traceback covers global/local/fit/overlap")
    if not pairs:
        raise ValueError("max() arg is an empty sequence: no pairs")
    for q, t in pairs:
        if mode == "global" and abs(len(t) - len(q)) > band:
            raise ValueError("band cannot contain the end cell")
        if mode == "fit" and len(q) > len(t):
            raise ValueError("first sequence must be shorter than the second")
    check_f32_exact(params, max(len(q) + len(t) for q, t in pairs), 0, mode)
    device = resolve_device(device)
    pmat = params_matrix(params, device)
    budget = int(batch._hbm_budget(device) * batch.PTR_BUDGET_FRAC)
    t0 = time.perf_counter()
    out = {}
    pending, outstanding = [], 0
    for idx, m_pad in plan(pairs, band, budget):
        est = _slab_bytes(m_pad, band) * len(idx)
        if pending and outstanding + est > budget:
            t0 = batch._tick(counters, "fill_seconds", t0)
            _collect(mode, pending, pairs, out)
            t0 = batch._tick(counters, "walk_seconds", t0)
            pending, outstanding = [], 0
        pending.append(_dispatch_rows(mode, _slab(idx, pairs, m_pad), band,
                                      pmat, device))
        outstanding += est
    t0 = batch._tick(counters, "fill_seconds", t0)
    _collect(mode, pending, pairs, out)
    results, edges = [], np.empty(len(pairs), np.float64)
    for k in range(len(pairs)):
        score, edges[k], err, rows = out[k]
        if mode == "fit" and not np.isfinite(score):
            raise RuntimeError(
                "fit: no finite traceback start in band (reference UB)")
        if err:
            raise _walk_error(mode, err)
        results.append(AlignResult(score, *rows))
    batch._tick(counters, "walk_seconds", t0)
    return results, edges


def banded_align(
    mode: str,
    q: bytes,
    t: bytes,
    band: int,
    params: AlignParams = AlignParams(),
    *,
    device="cuda",
):
    """Banded alignment WITH rows for one pair; returns (AlignResult,
    edge_best)."""
    results, edges = banded_align_batch(mode, [(q, t)], band, params,
                                        device=device)
    return results[0], float(edges[0])

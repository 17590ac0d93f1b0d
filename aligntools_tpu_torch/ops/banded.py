"""Banded DP fill in window coordinates: the CUDA kernel's wrapper and its
plain version.

Counterpart of ``aligntools_tpu/ops/pallas_banded.py`` (the Pallas
``_banded_kernel``, entries ``banded_pallas_scores`` and
``banded_pallas_full``). Query row i keeps a window of V = 2W+1 lanes,
lane k holding column j = i - W + k; cells with |j - i| > W are -inf
(+inf for edit). Inputs:

  qs      (B, m_pad) int32 query chars, pad -1
  te      (B, n_ext) int32 target with W pad columns on the left: target
          char j-1 at te[b, W + j - 1], pad -2; row i reads
          te[b, i-1 : i-1+V], indices clipped to n_ext - 1
  ns, ms  (B, 1) int32 true target / query lengths
  params  (1, 8) float32 [match, mismatch, gap_open, gap_extend, ...]

Outputs:

  best    (B,) float32: the score (edit's distance too, +inf out of band)
  edge    (B,) float32: the best value on the band's two boundary lanes,
          the diagnostic ``engine/banded.band_certificate`` stands beside
  a, b    (B,) int32 traceback-start info (``banded_full``)
            global   a = start state (0 L, 1 M, 2 U at (m, n))
            local    a = i_max, b = j_max (strict running argmax of M)
            fit      a = 1 when L wins the bottom row, b = j_max
            overlap  a = j_max (0 unless the bottom row's max beats 0)
  ptrs    (B, m_pad, V_pad) uint8, V_pad = V rounded up to 16: one byte a
          cell in ``layout.py``'s rows-per-byte-1 layout (overlap: its
          codes 0-3); cell (i, j) at ptrs[b, i-1, j - i + W]. Every byte is
          written: pad rows by the recurrence (they read the sentinel
          chars), pad lanes k >= V unset (7, overlap 3), where the Pallas
          kernel leaves whatever its buffer held.

The Pallas kernel streams a (B, m_pad, V_pad) gather of per-row target
windows (``build_t_win``) and takes each row's query char with a one-hot
matrix product, because Mosaic can neither slice lanes nor index them
dynamically; the CUDA kernel reads both straight from ``qs`` and ``te``.

On a CUDA tensor the wrappers launch ``csrc/banded_fill.cu`` (a warp per
pair for windows up to 32 * WARP_STRIPS[-1] lanes, a team of warps per pair
beyond, several pairs a CTA or a cluster of CTAs a pair, up to MAX_LANES:
``launch_shape``, ``cta_shape``; a strip of lanes per thread; see its
header) or raise;
on a CPU tensor they run the plain version, which repeats the Pallas kernel's
arithmetic row by row over whole (B, V) windows. Values are integer-valued
float32 with true infinite borders and every pointer is a comparison of
such values in the Pallas code's argument order, so the two agree bit for
bit.
"""

from __future__ import annotations

import ctypes

import torch

from aligntools_tpu_torch import layout as L
from aligntools_tpu_torch.ops.scan import check_tensors
from aligntools_tpu_torch.params import MODES

NEG = float("-inf")
POS = float("inf")
BIG = 1 << 30  # the start column when no column qualifies
PTR_MODES = ("global", "local", "fit", "overlap")
# the CTA path: strips of CTA_STRIPS lanes a thread (the narrowest whose
# team fits a cluster: a row's chain grows with the strip, and on one H100 a
# team of 4-lane warps was the fastest at every band it holds, PERF.md), at
# most CTA_WARPS warps a CTA (its instances' launch bound: 256
# threads of up to 255 registers), pairs that need fewer sharing a CTA, and
# a pair wider than a CTA spanning a cluster of up to CLUSTER_MAX CTAs (past
# 8 a non-portable size, which the H100 takes); so the widest window it
# takes
CTA_STRIPS = (4, 8, 16)
CTA_WARPS = 8
CLUSTER_MAX = 16
# the H100's SMs: a CTA of ~200-register threads fills one, so teams share a
# CTA only where the batch leaves every SM a CTA
SMS = 132
# 65,536 lanes: W <= 32,767
MAX_LANES = CLUSTER_MAX * CTA_WARPS * 32 * CTA_STRIPS[-1]
# the warp path's strips (lanes a thread: a warp holds V <= 32 * S lanes),
# and the pairs (warps) of its CTA. By default the path depends on the band
# alone: at 16 lanes a thread and tens of pairs the CTA path fills pointers
# faster (PERF.md), but the main path's slabs hold thousands of pairs; a
# calibrated table may set a batch threshold for each strip
# (engine/select.banded_path).
WARP_STRIPS = (5, 9, 16)
WARP_PAIRS = 4

launches = 0
launches_cta = 0  # those of them on the CTA path
plain_calls = 0


def reset_counts() -> None:
    global launches, launches_cta, plain_calls
    launches = launches_cta = plain_calls = 0


def lanes_padded(band: int) -> int:
    """V_pad: the pointer row's width, V = 2W+1 rounded up to 16."""
    return -(-(2 * band + 1) // 16) * 16


def launch_shape(band: int) -> tuple[str, int, int]:
    """(path, threads per CTA, lanes per thread) for a window of V = 2W+1
    lanes: "warp", a warp per pair and WARP_PAIRS pairs a CTA, with the
    narrowest strip of WARP_STRIPS that holds V in one warp; past 32 *
    WARP_STRIPS[-1] lanes "cta" (``cta_shape``; ValueError past
    MAX_LANES). ``_launch`` takes the CTA path below the table's batch
    threshold for the strip too (``engine/select.banded_path``; by default
    at no batch)."""
    V = 2 * band + 1
    strip = next((s for s in WARP_STRIPS if 32 * s >= V), None)
    if strip:
        return "warp", 32 * WARP_PAIRS, strip
    return cta_shape(band)


def cta_shape(band: int, batch: int | None = None) -> tuple[str, int, int]:
    """The CTA path's shape at ``band``: (path, threads a CTA, lanes a
    thread). A pair takes the fewest warps that hold V (its team) at the
    narrowest strip of CTA_STRIPS whose team fits a cluster of CLUSTER_MAX
    CTAs; teams of up to CTA_WARPS / 2 warps share a CTA of up to
    CTA_WARPS warps (with ``batch``, only as many as leave every SM a
    CTA), and a team wider than a CTA spans a cluster of CTAs of equal
    warps (``cta_geometry``). Past MAX_LANES lanes no instance takes the
    band: ValueError."""
    V = 2 * band + 1
    if V > MAX_LANES:
        raise ValueError(f"band {band} is wider than the banded kernel's "
                         f"{MAX_LANES} lanes (W <= {(MAX_LANES - 1) // 2})")
    strip = next(s for s in CTA_STRIPS
                 if V <= CLUSTER_MAX * CTA_WARPS * 32 * s)
    need = -(-V // (32 * strip))
    if need <= CTA_WARPS:
        pairs = CTA_WARPS // need
        if batch is not None:
            pairs = max(1, min(pairs, batch // SMS))
        return "cta", 32 * need * pairs, strip
    return "cta", 32 * -(-need // -(-need // CTA_WARPS)), strip


def cta_geometry(band: int, threads: int,
                 strip: int) -> tuple[int, int, int]:
    """(warps a pair, pairs a CTA, CTAs a pair) of a CTA-path launch of
    ``threads`` of ``strip`` lanes at ``band``, as ``at_banded_fill``
    derives it: a CTA holding a multiple of the team's warps takes that
    many pairs; else a pair spans a cluster of CTAs, its team every warp of
    them (those past the window hold pad lanes only). ValueError where the
    kernel has no instance for the launch."""
    V = 2 * band + 1
    need, wpc = -(-V // (32 * strip)), threads // 32
    if (V > MAX_LANES or strip not in CTA_STRIPS or threads % 32
            or not 0 < wpc <= CTA_WARPS
            or (wpc >= need and wpc % need)
            or -(-need // wpc) > CLUSTER_MAX):
        raise ValueError(f"no CTA-path launch of {threads} threads of "
                         f"{strip} lanes at band {band}")
    if wpc >= need:
        return need, wpc // need, 1
    C = -(-need // wpc)
    return C * wpc, 1, C


# ---------------------------------------------------------------------------
# Plain PyTorch version
# ---------------------------------------------------------------------------


def _shl(x, fill):
    """[x[:, 1:], fill]: lane k reads lane k+1 (the vertical predecessor)."""
    return torch.nn.functional.pad(x[:, 1:], (0, 1), value=fill)


def _shr(x, fill):
    """[fill, x[:, :-1]]: lane k reads lane k-1 (the horizontal one)."""
    return torch.nn.functional.pad(x[:, :-1], (1, 0), value=fill)


def _first_j(hit, jcol):
    return torch.where(hit, jcol, BIG).amin(dim=1, keepdim=True)


def _fill_plain(mode, band, emit, qs, te, ns, ms, params):
    global plain_calls
    plain_calls += 1
    W, V = band, 2 * band + 1
    B, m_pad = qs.shape
    n_ext, dev = te.shape[1], qs.device
    match, mis, o, e = (params[0, k] for k in range(4))
    kidx = torch.arange(V, device=dev, dtype=torch.int32)[None, :]
    lanes = torch.arange(V, device=dev)
    j0 = kidx - W
    n_col, m_col = ns, ms
    # the rows where a pair ends: start info latches there only
    ends = set(ms.flatten().tolist())
    bad = POS if mode == "edit" else NEG
    best = torch.full((B, 1), bad, device=dev)
    edge = torch.full((B, 1), bad, device=dev)
    a = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    b = torch.zeros((B, 1), dtype=torch.int32, device=dev)
    ptrs = None
    if emit:
        unset = L.OV_UNSET if mode == "overlap" else L.PK_UNSET
        ptrs = torch.full((B, m_pad, lanes_padded(band)), unset,
                          dtype=torch.uint8, device=dev)

    def rows_of(v):
        return v.to(torch.float32).expand(B, V).clone()

    zero = torch.zeros((), device=dev)
    # row 0
    if mode == "edit":
        mp = rows_of(torch.where(j0 >= 0, j0.to(torch.float32), POS))
    elif mode == "overlap":
        mp = rows_of(torch.where(j0 == 0, 0.0, NEG))
    elif mode == "global":
        mp = rows_of(torch.where(j0 == 0, 0.0, NEG))
        lp = rows_of(torch.where(j0 == 0, o, NEG))
        up = rows_of(torch.where(j0 >= 0, o + e * j0.to(torch.float32), NEG))
    elif mode == "fit":
        mp = up = rows_of(torch.where(j0 >= 0, 0.0, NEG))
        lp = rows_of(torch.full_like(j0, NEG, dtype=torch.float32))
    else:  # local
        mp = lp = up = rows_of(torch.where(j0 >= 0, 0.0, NEG))
    for idx in range(m_pad):
        i = idx + 1
        i_f = float(i)
        tw = (te[:, idx : idx + V] if idx + V <= n_ext
              else te[:, torch.clamp(lanes + idx, max=n_ext - 1)])
        qc = qs[:, idx : idx + 1]
        jcol = i - W + kidx
        jf = jcol.to(torch.float32)
        in_mat = (jcol >= 1) & (jcol <= n_col) & (i <= m_col)
        # columns 0 and 1 lie in the window only while i - W <= 1; past
        # that the border selects below would change nothing
        border = i - W <= 1
        if border:
            at_j0, at_j0_diag = jcol == 0, jcol == 1
        latch = m_col == i if i in ends else None
        if mode == "edit":
            sub = torch.where(tw == qc, zero, mis)
            diag = torch.where(at_j0_diag, i_f - 1.0, mp) if border else mp
            cand2 = torch.minimum(diag + sub, _shl(mp, POS) + 1.0)
            cand2 = torch.where(in_mat, cand2, POS)
            cd = cand2 - jf
            if border:
                cd = torch.where(at_j0, i_f, torch.where(
                    at_j0_diag, torch.clamp_max(cd, i_f), cd))
            row = torch.cummin(cd, dim=1).values + jf
            row = torch.where(in_mat, torch.minimum(row, cand2), POS)
            if latch is not None:
                fin = torch.where(jcol == n_col, row, POS).amin(
                    1, keepdim=True)
                best = torch.where(latch, fin, best)
            edge = torch.minimum(edge, torch.minimum(row[:, :1],
                                                     row[:, V - 1 :]))
            mp = row
            continue
        sub = torch.where(tw == qc, match, mis)
        if mode == "overlap":
            diag, vert = mp, _shl(mp, NEG)
            if border:
                diag = torch.where(at_j0_diag, 0.0, diag)
                vert = torch.where(at_j0, 0.0, vert)
            dd, vv = diag + sub, vert + o
            cand = torch.where(in_mat, torch.maximum(dd, vv), NEG)
            cd = cand - o * jf
            if border:
                cd = torch.where(at_j0, 0.0, cd)
            row = torch.cummax(cd, dim=1).values + o * jf
            row = torch.where(in_mat, row, NEG)
            if latch is not None:
                lt_n = jcol <= n_col - 1
                rowmax = torch.where(lt_n, row, NEG).amax(1, keepdim=True)
                best = torch.where(latch, torch.clamp_min(rowmax, 0.0), best)
            if emit:
                # codes in argument order LEFT, DIAG, RIGHT
                lh = _shr(row, NEG)
                if border:
                    lh = torch.where(at_j0_diag, 0.0, lh)
                code = torch.where(lh + o >= row, L.OV_LEFT,
                                   torch.where(dd >= vv, L.OV_DIAG,
                                               L.OV_RIGHT))
                code = torch.where(row > NEG, code, L.OV_UNSET)
                ptrs[:, idx, :V] = code.to(torch.uint8)
            if emit and latch is not None:
                jarg = _first_j((row == rowmax) & lt_n & in_mat, jcol)
                jarg = torch.where(rowmax > 0.0, jarg, 0)
                a = torch.where(latch, jarg, a)
            edge = torch.maximum(edge, torch.maximum(row[:, :1],
                                                     row[:, V - 1 :]))
            mp = row
            continue
        # the affine family: global / local / fit
        diag_m, diag_l, diag_u = mp, lp, up
        vert_m, vert_l = _shl(mp, NEG), _shl(lp, NEG)
        if border:
            if mode == "global":
                b_l = o + e * (i_f - 1.0)  # L(i-1, 0)
                diag_m = torch.where(at_j0_diag, 0.0 if i == 1 else NEG,
                                     diag_m)
                diag_l = torch.where(at_j0_diag, b_l, diag_l)
                diag_u = torch.where(at_j0_diag, o if i == 1 else NEG, diag_u)
                vert_m = torch.where(at_j0, NEG, vert_m)
                vert_l = torch.where(at_j0, b_l, vert_l)
            elif mode == "fit":
                b_mu = 0.0 if i == 1 else NEG  # M(i-1, 0) = U(i-1, 0)
                diag_m = torch.where(at_j0_diag, b_mu, diag_m)
                diag_l = torch.where(at_j0_diag, NEG, diag_l)
                diag_u = torch.where(at_j0_diag, b_mu, diag_u)
                vert_m = torch.where(at_j0, b_mu, vert_m)
                vert_l = torch.where(at_j0, NEG, vert_l)
            else:
                diag_m = torch.where(at_j0_diag, 0.0, diag_m)
                diag_l = torch.where(at_j0_diag, 0.0, diag_l)
                diag_u = torch.where(at_j0_diag, 0.0, diag_u)
                vert_m = torch.where(at_j0, 0.0, vert_m)
                vert_l = torch.where(at_j0, 0.0, vert_l)
        cand_l, cand_m, cand_u = diag_l + sub, diag_m + sub, diag_u + sub
        best3 = torch.maximum(torch.maximum(cand_l, cand_m), cand_u)
        m_row = torch.clamp_min(best3, 0.0) if mode == "local" else best3
        m_row = torch.where(in_mat, m_row, NEG)
        la, lb = vert_l + e, vert_m + o
        l_row = torch.where(in_mat, torch.maximum(la, lb), NEG)
        cand = _shr(m_row, NEG) + o - e * jf
        if mode == "local" and border:
            cand = torch.where(at_j0, 0.0 - e * jf, cand)
            cand = torch.where(at_j0_diag,
                               torch.maximum(cand, 0.0 + o - e * jf), cand)
        u_row = torch.cummax(cand, dim=1).values
        if mode == "local":
            u_row = torch.clamp_min(u_row, 0.0)
        u_row = torch.where(in_mat, u_row + e * jf, NEG)
        if emit:
            pm = torch.where(cand_l >= best3, L.PK_LOW,
                             torch.where(cand_m >= best3, L.PK_MID, L.PK_UPP))
            if mode == "local":  # the HOME candidate: the last argument
                pm = torch.where(best3 >= 0.0, pm, L.PK_HOME)
            pm = torch.where(m_row > NEG, pm, L.PK_UNSET)
            plb = torch.where(la >= lb, 0, L.PK_L_IS_MID)
            mh, uh = _shr(m_row, NEG), _shr(u_row, NEG)
            if mode == "local" and border:
                mh = torch.where(at_j0_diag, 0.0, mh)
                uh = torch.where(at_j0_diag, 0.0, uh)
            pub = torch.where(mh + o >= uh + e, 0, L.PK_U_IS_UPP)
            ptrs[:, idx, :V] = (pm | plb | pub).to(torch.uint8)
        if mode == "fit":
            if latch is not None:
                lt_n = jcol <= n_col - 1
                mb = torch.where(lt_n, m_row, NEG).amax(1, keepdim=True)
                lb3 = torch.where(lt_n, l_row, NEG).amax(1, keepdim=True)
                fin = torch.maximum(mb, lb3)
                best = torch.where(latch, fin, best)
                use_l = lb3 > mb  # M wins ties
                win = torch.where(use_l, l_row, m_row)
                jarg = _first_j((win == fin) & lt_n & in_mat, jcol)
                a = torch.where(latch, use_l.to(torch.int32), a)
                b = torch.where(latch, jarg, b)
        elif mode == "global":
            if latch is not None:
                at_n = jcol == n_col
                ln = torch.where(at_n, l_row, NEG).amax(1, keepdim=True)
                mn = torch.where(at_n, m_row, NEG).amax(1, keepdim=True)
                un = torch.where(at_n, u_row, NEG).amax(1, keepdim=True)
                st = torch.where((ln >= mn) & (ln >= un), 0,
                                 torch.where(mn >= un, 1, 2)).to(torch.int32)
                best = torch.where(latch, torch.maximum(torch.maximum(ln, mn),
                                                        un), best)
                a = torch.where(latch, st, a)
        else:  # local: running max of M, row-major, strict >
            rowmax = m_row.amax(1, keepdim=True)
            upd = rowmax > best
            jarg = _first_j((m_row == rowmax) & in_mat, jcol)
            a = torch.where(upd, i, a)
            b = torch.where(upd, jarg, b)
            best = torch.maximum(best, rowmax)
        edge = torch.maximum(edge, torch.maximum(m_row[:, :1],
                                                 m_row[:, V - 1 :]))
        mp, lp, up = m_row, l_row, u_row
    return best[:, 0], edge[:, 0], a[:, 0], b[:, 0], ptrs


def banded_scores_plain(mode, band, qs, te, ns, ms, params):
    """Plain version of ``banded_scores`` (any device)."""
    return _fill_plain(mode, band, False, qs, te, ns, ms, params)[:2]


def banded_full_plain(mode, band, qs, te, ns, ms, params):
    """Plain version of ``banded_full`` (any device)."""
    return _fill_plain(mode, band, True, qs, te, ns, ms, params)


# ---------------------------------------------------------------------------
# Kernel wrapper
# ---------------------------------------------------------------------------

_fn = None


def _kernel():
    global _fn
    if _fn is None:
        from aligntools_tpu_torch.ops import _build

        fn = _build.load().at_banded_fill
        P, I = ctypes.c_void_p, ctypes.c_int
        # mode, emit, qs, te, ns, ms, params, best, edge, a, b, ptrs, B,
        # m_pad, n_ext, band, v_pad, threads, strip, warp, stream
        fn.argtypes = [I, I, P, P, P, P, P, P, P, P, P, P, I, I, I, I, I, I,
                       I, I, P]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def _check(mode, modes, band, qs, te, ns, ms, params):
    if mode not in modes:
        raise ValueError(f"unknown banded mode {mode!r}: {modes}")
    if band < 0:
        raise ValueError(f"band {band} is negative")
    B, m_pad = qs.shape if qs.dim() == 2 else (-1, -1)
    n_ext = te.shape[1] if te.dim() == 2 else -1
    if n_ext < 1:
        raise ValueError("te needs at least one column")
    check_tensors([("qs", qs, torch.int32, (B, m_pad)),
                   ("te", te, torch.int32, (B, n_ext)),
                   ("ns", ns, torch.int32, (B, 1)),
                   ("ms", ms, torch.int32, (B, 1)),
                   ("params", params, torch.float32, (1, 8))], qs.device)


def _launch(mode, emit, band, qs, te, ns, ms, params, shape=None):
    """Launch the kernel on CUDA tensors at ``shape`` = (path, threads,
    strip), by default the path ``engine/select.banded_path(band, B)``
    picks (``launch_shape(band)``, or ``cta_shape(band, B)``); the C entry
    refuses a shape it has no instance for."""
    global launches, launches_cta
    from aligntools_tpu_torch.engine import select

    B, m_pad = qs.shape
    dev = qs.device
    if shape is None:
        shape = (launch_shape(band) if select.banded_path(band, B) == "warp"
                 else cta_shape(band, B))
    path, threads, strip = shape
    best = torch.empty(B, dtype=torch.float32, device=dev)
    edge = torch.empty(B, dtype=torch.float32, device=dev)
    a = torch.empty(B, dtype=torch.int32, device=dev)
    b = torch.empty(B, dtype=torch.int32, device=dev)
    v_pad = lanes_padded(band)
    ptrs = (torch.empty((B, m_pad, v_pad), dtype=torch.uint8, device=dev)
            if emit else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _kernel()(
            MODES.index(mode), int(emit), qs.data_ptr(), te.data_ptr(),
            ns.data_ptr(), ms.data_ptr(), params.data_ptr(), best.data_ptr(),
            edge.data_ptr(), a.data_ptr(), b.data_ptr(),
            ptrs.data_ptr() if emit else 0, B, m_pad, te.shape[1], band,
            v_pad, threads, strip, int(path == "warp"), stream)
    if err != 0:
        raise RuntimeError(f"banded fill kernel launch failed: CUDA error "
                           f"{err}")
    launches += 1
    launches_cta += path == "cta"
    return best, edge, a, b, ptrs


def banded_scores(mode, band, qs, te, ns, ms, params):
    """Score-only banded fill for all five modes; returns (best, edge), (B,)
    float32 each (the counterpart of ``banded_pallas_scores``)."""
    _check(mode, MODES, band, qs, te, ns, ms, params)
    if qs.device.type == "cpu":
        return banded_scores_plain(mode, band, qs, te, ns, ms, params)
    return _launch(mode, False, band, qs, te, ns, ms, params)[:2]


def banded_full(mode, band, qs, te, ns, ms, params):
    """Pointer-emitting banded fill for global, local, fit and overlap (edit
    has no traceback); returns (best, edge, a, b, ptrs) as the module
    docstring lays them out (the counterpart of ``banded_pallas_full``)."""
    _check(mode, PTR_MODES, band, qs, te, ns, ms, params)
    if qs.device.type == "cpu":
        return banded_full_plain(mode, band, qs, te, ns, ms, params)
    return _launch(mode, True, band, qs, te, ns, ms, params)

"""Score-only DP fills: CUDA kernel wrappers and their plain PyTorch versions.

Counterpart of ``aligntools_tpu/ops/pallas_scan.py``, with its entry
points' argument layout:

  qs      (B, m_pad) int32 query chars, pad -1
  ts      (B, n_pad) int32 target chars, pad -2
  allow   (B, n_pad) float32, 1.0 where fit's jump entry is allowed
  ns, ms  (B, 1) int32 true target / query lengths
  params  (1, 8) float32 [match, mismatch, gap_open, gap_extend, jump, 0, 0, 0]

``scores`` / ``fit_scores`` return (B,) float32 scores (int32 for edit).
On a CUDA tensor they launch the hand-written kernels or raise: the
register-strip score fills of ``csrc/ptr_fill.cu`` (one CTA per pair, each
thread's strip of 16 columns and its row state in registers; entry
``at_score_fill``): global, local, fit(+jump) and overlap the score-only
instances of its pointer kernels, edit its int32 min-plus kernel, each up
to ``flat_cap(mode)`` columns at ``flat_shape(mode, n_pad)``. Wider targets
go to the blocked score fill (``ops/blocked.py``) at ``blocked.C_BLK``,
with a ragged last block where it does not divide n_pad, on either device:
``blocked_c_blk`` is the one place that picks. On a CPU tensor the wrappers
run the plain versions below. Scores are integer-valued float32 with true
-inf borders, so the kernel and the plain version agree bit for bit (the
batch path guards the exact range with ``exact.check_f32_exact``).

The plain versions fill one query row per step over whole (B, n_pad)
rows, as the Pallas kernels do, and resolve each in-row gap chain with
the slope-normalized running max / min of ``engine/scan.py:_u_scan``
(``torch.cummax`` / ``torch.cummin``).
"""

from __future__ import annotations

import ctypes

import torch

from aligntools_tpu_torch.params import MODES

NEG = float("-inf")
INT32_MAX = 2**31 - 1

# launches of each kernel through its wrapper, keyed by the TPU kernel it
# replaces, and calls of the plain versions: a run can show which of the
# two carried it
launches = {"affine": 0, "overlap": 0, "edit": 0, "fit": 0}
plain_calls = 0

# the most threads the edit kernel's CTA runs (csrc/ptr_fill.cu
# kEditMaxThreads): two words a column leave it 64 registers a thread
EDIT_MAX_THREADS = 1024


def reset_counts() -> None:
    global plain_calls
    for k in launches:
        launches[k] = 0
    plain_calls = 0


def flat_cap(mode: str) -> int:
    """The widest target (n_pad) the register-strip score fill of ``mode``
    takes: ``ptr.FLAT_REG_MAX_N_PAD``, and for edit, whose CTA may run more
    threads, EDIT_MAX_THREADS strips."""
    from aligntools_tpu_torch.ops import ptr

    if mode == "edit":
        return EDIT_MAX_THREADS * ptr.WIDTH
    return ptr.FLAT_REG_MAX_N_PAD


def flat_shape(mode: str, n_pad: int) -> tuple[int, int]:
    """(threads per CTA, strip width) of the register-strip score fill of
    ``mode`` at n_pad: the fewest whole warps of strips that cover it."""
    from aligntools_tpu_torch.ops import ptr

    cap = flat_cap(mode)
    if not 0 < n_pad <= cap:
        raise ValueError(f"n_pad {n_pad} is past the {mode} score fill's "
                         f"{cap} columns: the blocked fill takes it")
    return max(32, -(-n_pad // (32 * ptr.WIDTH)) * 32), ptr.WIDTH


def blocked_c_blk(mode: str, n_pad: int) -> int | None:
    """The column block at which ``scores`` / ``fit_scores`` hand a target
    of n_pad columns to the blocked score fill, or None where the
    register-strip fill takes it (up to ``flat_cap(mode)``)."""
    from aligntools_tpu_torch.ops import blocked

    return None if n_pad <= flat_cap(mode) else blocked.C_BLK


# ---------------------------------------------------------------------------
# Plain PyTorch versions
# ---------------------------------------------------------------------------


def _shift_in(x, col):
    """[col, x[:, :-1]]: shift right one column, border column in front."""
    return torch.cat([col, x[:, :-1]], dim=1)


def _cummax(x):
    return torch.cummax(x, dim=1).values


def _affine_plain(local, m_pad, n_pad, qs, ts, ns, ms, params):
    match, mis, o, e = (params[0, k] for k in range(4))
    B, dev = qs.shape[0], qs.device
    jf = torch.arange(1, n_pad + 1, device=dev, dtype=torch.float32)[None, :]
    jc = torch.arange(1, n_pad + 1, device=dev, dtype=torch.int32)[None, :]
    ej = e * jf
    oj = o - ej
    zcol = torch.zeros((B, 1), device=dev)
    negcol = torch.full((B, 1), NEG, device=dev)
    zero = torch.zeros((), device=dev)
    if local:  # calloc-zero borders
        mp = lp = best = torch.zeros((B, n_pad), device=dev)
    else:  # row 0: M = L = -inf, U = o + e*j
        mp = lp = torch.full((B, n_pad), NEG, device=dev)
        best = (o + ej).expand(B, n_pad)
    acc = torch.full((B, n_pad), NEG, device=dev)
    for i in range(1, m_pad + 1):
        sub = torch.where(ts == qs[:, i - 1 : i], match, mis)
        l_row = torch.maximum(lp + e, mp + o)
        if local:
            m_row = torch.maximum(_shift_in(best, zcol) + sub, zero)
            u_row = torch.maximum(_cummax(_shift_in(m_row, zcol) + oj), zero) + ej
            acc = torch.maximum(acc, torch.where(ms >= i, m_row, NEG))
        else:
            # column-0 diagonal border: 0 at i = 1, then L(i-1, 0)
            bb = zcol if i == 1 else zcol + (o + e * (i - 1.0))
            m_row = _shift_in(best, bb) + sub
            u_row = _cummax(_shift_in(m_row, negcol) + oj) + ej
        best = torch.maximum(torch.maximum(l_row, m_row), u_row)
        if not local:
            acc = torch.where(ms == i, best, acc)
        mp, lp = m_row, l_row
    mask = jc <= ns if local else jc == ns
    out = torch.where(mask, acc, NEG).amax(dim=1)
    return out + 0.0 if local else out


def _overlap_plain(m_pad, n_pad, qs, ts, ns, ms, params):
    match, mis, o = (params[0, k] for k in range(3))
    B, dev = qs.shape[0], qs.device
    jf = torch.arange(1, n_pad + 1, device=dev, dtype=torch.float32)[None, :]
    jc = torch.arange(1, n_pad + 1, device=dev, dtype=torch.int32)[None, :]
    ojc = o * jf
    zcol = torch.zeros((B, 1), device=dev)
    zero = torch.zeros((), device=dev)
    mp = torch.full((B, n_pad), NEG, device=dev)  # row 0 past column 0
    acc = torch.full((B, n_pad), NEG, device=dev)
    for i in range(1, m_pad + 1):
        sub = torch.where(ts == qs[:, i - 1 : i], match, mis)
        dr = torch.maximum(_shift_in(mp, zcol) + sub, mp + o)
        mp = torch.maximum(_cummax(dr - ojc), zero) + ojc  # M(i, 0) = 0 seed
        acc = torch.where(ms == i, mp, acc)
    fin = torch.where(jc <= ns - 1, acc, NEG).amax(dim=1)
    return torch.maximum(fin, zero) + 0.0  # the j = 0 border's 0


def _edit_plain(m_pad, n_pad, qs, ts, ns, ms, params):
    B, dev = qs.shape[0], qs.device
    u = params[0, 1].to(torch.int32)
    zero = torch.zeros((), dtype=torch.int32, device=dev)
    jc = torch.arange(1, n_pad + 1, device=dev, dtype=torch.int32)[None, :]
    prev = jc.expand(B, n_pad)  # M(0, j) = j
    acc = torch.zeros((B, n_pad), dtype=torch.int32, device=dev)
    for i in range(1, m_pad + 1):
        sub = torch.where(ts == qs[:, i - 1 : i], zero, u)
        pb = torch.full((B, 1), i - 1, dtype=torch.int32, device=dev)
        cand = torch.minimum(_shift_in(prev, pb) + sub, prev + 1)
        # row[0] = i; row[j] = min(cand[j], row[j-1] + 1)
        v = torch.clamp_max(torch.cummin(cand - jc, dim=1).values, i)
        prev = v + jc
        acc = torch.where(ms == i, prev, acc)
    return torch.where(jc == ns, acc, INT32_MAX).amin(dim=1)


def _fit_plain(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms, params):
    match, mis, o, e, jp = (params[0, k] for k in range(5))
    B, dev = qs.shape[0], qs.device
    jf = torch.arange(1, n_pad + 1, device=dev, dtype=torch.float32)[None, :]
    jc = torch.arange(1, n_pad + 1, device=dev, dtype=torch.int32)[None, :]
    ej = e * jf
    zcol = torch.zeros((B, 1), device=dev)
    negcol = torch.full((B, 1), NEG, device=dev)
    # row 0: M = U = 0, L = J = -inf
    mp = best = torch.zeros((B, n_pad), device=dev)
    lp = torch.full((B, n_pad), NEG, device=dev)
    acc = torch.full((B, n_pad), NEG, device=dev)
    if use_jump:  # jp where jump entry is allowed, -inf elsewhere
        jbias = torch.where(allow > 0.0, jp, NEG)
    for i in range(1, m_pad + 1):
        sub = torch.where(ts == qs[:, i - 1 : i], match, mis)
        # the column-0 diagonal border is 0 only at i = 1
        m_row = _shift_in(best, zcol if i == 1 else negcol) + sub
        l_row = torch.maximum(lp + e, mp + o)
        sm = _shift_in(m_row, negcol)
        u_row = _cummax(sm + (o - ej)) + ej
        best_ml = torch.maximum(m_row, l_row)
        best = torch.maximum(best_ml, u_row)
        if use_jump:  # J carries for free: a max-scan with no slope
            best = torch.maximum(best, _cummax(sm + jbias))
        acc = torch.where(ms == i, best_ml, acc)  # U is excluded
        mp, lp = m_row, l_row
    return torch.where(jc <= ns - 1, acc, NEG).amax(dim=1)


def scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, params):
    """Plain version of ``scores`` (any device)."""
    global plain_calls
    plain_calls += 1
    if mode in ("global", "local"):
        return _affine_plain(mode == "local", m_pad, n_pad, qs, ts, ns, ms,
                             params)
    if mode == "overlap":
        return _overlap_plain(m_pad, n_pad, qs, ts, ns, ms, params)
    if mode == "edit":
        return _edit_plain(m_pad, n_pad, qs, ts, ns, ms, params)
    raise ValueError(f"unknown score mode {mode!r}")


def fit_scores_plain(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms, params):
    """Plain version of ``fit_scores`` (any device)."""
    global plain_calls
    plain_calls += 1
    return _fit_plain(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms, params)


# ---------------------------------------------------------------------------
# Kernel wrappers
# ---------------------------------------------------------------------------

_lib = None


def _kernels():
    """The built kernel library with its C signatures declared (every
    pointer and the stream as c_void_p, so ctypes keeps all 64 bits)."""
    global _lib
    if _lib is None:
        from aligntools_tpu_torch.ops import _build

        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        # mode, use_jump, qs, ts, allow, ns, ms, params, out, B, m_pad,
        # n_pad, threads, width, stream
        lib.at_score_fill.argtypes = [I, I, P, P, P, P, P, P, P, I, I, I, I,
                                      I, P]
        lib.at_score_fill.restype = ctypes.c_int
        _lib = lib
    return _lib


def check_tensors(want, device):
    """Raise unless every (name, tensor, dtype, shape) of ``want`` has its
    dtype and shape, lies contiguous on ``device``, a CPU or CUDA device."""
    for name, x, dtype, shape in want:
        if x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(
                f"{name}: want {dtype} {shape}, got {x.dtype} "
                f"{tuple(x.shape)}"
            )
        if x.device != device:
            raise ValueError(f"{name} is on {x.device}, qs on {device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")


def _check(m_pad, n_pad, qs, ts, ns, ms, params, allow=None):
    B = qs.shape[0] if qs.dim() == 2 else -1
    want = [("qs", qs, torch.int32, (B, m_pad)),
            ("ts", ts, torch.int32, (B, n_pad)),
            ("ns", ns, torch.int32, (B, 1)),
            ("ms", ms, torch.int32, (B, 1)),
            ("params", params, torch.float32, (1, 8))]
    if allow is not None:
        want.append(("allow", allow, torch.float32, (B, n_pad)))
    check_tensors(want, qs.device)


def _launch_strip(mode, use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                  params):
    """Launch the register-strip score fill of ``mode`` (``allow`` read
    with fit's jump alone) on CUDA tensors at ``flat_shape(mode, n_pad)``
    on the current stream (the C entry refuses an n_pad off the 16-column
    grid); returns (B,) float32, int32 for edit."""
    threads, width = flat_shape(mode, n_pad)
    if ts.data_ptr() % 16:
        raise ValueError("ts must be 16-byte aligned (the kernel reads it "
                         "as 16-byte words)")
    out = torch.empty(qs.shape[0], device=qs.device,
                      dtype=torch.int32 if mode == "edit" else torch.float32)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = _kernels().at_score_fill(
            MODES.index(mode), int(bool(use_jump)), qs.data_ptr(),
            ts.data_ptr(), allow.data_ptr() if use_jump else None,
            ns.data_ptr(), ms.data_ptr(), params.data_ptr(), out.data_ptr(),
            qs.shape[0], m_pad, n_pad, threads, width, stream)
    if err != 0:
        raise RuntimeError(f"{mode} score fill kernel launch failed: CUDA "
                           f"error {err}")
    launches["affine" if mode in ("global", "local") else mode] += 1
    return out


def scores(mode, m_pad, n_pad, qs, ts, ns, ms, params):
    """Score-only fill for global / local / overlap / edit (the
    counterpart of ``pallas_scores``). Returns (B,) float32, int32 for
    edit. Targets past ``flat_cap(mode)`` run the blocked score fill at
    ``blocked_c_blk(mode, n_pad)``."""
    c_blk = blocked_c_blk(mode, n_pad)
    if c_blk:
        from aligntools_tpu_torch.ops import blocked

        return blocked.blocked_scores(mode, False, m_pad, n_pad, c_blk, qs,
                                      ts, None, ns, ms, params)
    _check(m_pad, n_pad, qs, ts, ns, ms, params)
    if qs.device.type == "cpu":
        return scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, params)
    if mode in ("global", "local", "overlap", "edit"):
        return _launch_strip(mode, False, m_pad, n_pad, qs, ts, None, ns, ms,
                             params)
    raise ValueError(f"unknown score mode {mode!r}")


def fit_scores(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms, params):
    """Fit-mode score fill (the counterpart of ``pallas_fit_scores``).
    Returns (B,) float32. ``allow`` may be None without ``use_jump`` (every
    column allowed). Targets past ``flat_cap("fit")`` columns run the
    blocked score fill at ``blocked_c_blk("fit", n_pad)``."""
    c_blk = blocked_c_blk("fit", n_pad)
    if c_blk:
        from aligntools_tpu_torch.ops import blocked

        return blocked.blocked_scores("fit", use_jump, m_pad, n_pad, c_blk,
                                      qs, ts, allow, ns, ms, params)
    if allow is None:
        allow = torch.ones(qs.shape[:1] + (n_pad,), device=qs.device)
    _check(m_pad, n_pad, qs, ts, ns, ms, params, allow)
    if qs.device.type == "cpu":
        return fit_scores_plain(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                                params)
    return _launch_strip("fit", use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                         params)

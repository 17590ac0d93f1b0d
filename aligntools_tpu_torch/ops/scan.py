"""Score-only DP fills: CUDA kernel wrappers and their plain PyTorch versions.

Counterpart of ``aligntools_tpu/ops/pallas_scan.py``, with its entry
points' argument layout:

  qs      (B, m_pad) int32 query chars, pad -1
  ts      (B, n_pad) int32 target chars, pad -2
  allow   (B, n_pad) float32, 1.0 where fit's jump entry is allowed
  ns, ms  (B, 1) int32 true target / query lengths
  params  (1, 8) float32 [match, mismatch, gap_open, gap_extend, jump, 0, 0, 0]

``scores`` / ``fit_scores`` return (B,) float32 scores (int32 for edit).
On a CUDA tensor they launch the hand-written kernels of
``csrc/scan_fill.cu`` (one CTA per pair; see its header) or raise; on a
CPU tensor they run the plain versions below. Scores are integer-valued
float32 with true -inf borders, so the kernel and the plain version agree
bit for bit (the batch path guards the exact range with
``exact.check_f32_exact``).

The plain versions fill one query row per step over whole (B, n_pad)
rows, as the Pallas kernels do, and resolve each in-row gap chain with
the slope-normalized running max / min of ``engine/scan.py:_u_scan``
(``torch.cummax`` / ``torch.cummin``).
"""

from __future__ import annotations

import ctypes

import torch

NEG = float("-inf")
INT32_MAX = 2**31 - 1

# launches of each kernel through its wrapper, and calls of the plain
# versions: a run can show which of the two carried it
launches = {"affine": 0, "overlap": 0, "edit": 0, "fit": 0}
plain_calls = 0

# scratch row buffers per pair (csrc/scan_fill.cu): state rows + chars
_NBUF = {"affine": 4, "overlap": 3, "edit": 3, "fit": 5}
STRIP = 8  # target columns per thread the launch shape aims for


def reset_counts() -> None:
    global plain_calls
    for k in launches:
        launches[k] = 0
    plain_calls = 0


def launch_shape(n_pad: int) -> tuple[int, int]:
    """(threads per CTA, strip slots per thread) for targets up to n_pad."""
    threads = min(1024, max(32, -(-n_pad // (32 * STRIP)) * 32))
    return threads, -(-n_pad // threads)


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
        tail = [P, P, I, I, I, I, I, P]  # out, scratch, B, m_pad, n_pad,
        #                                  threads, wmax, stream
        lib.at_affine_scores.argtypes = [I, P, P, P, P, P, *tail]
        lib.at_overlap_scores.argtypes = [P, P, P, P, P, *tail]
        lib.at_edit_scores.argtypes = [P, P, P, P, P, *tail]
        lib.at_fit_scores.argtypes = [I, P, P, P, P, P, P, *tail]
        for fn in (lib.at_affine_scores, lib.at_overlap_scores,
                   lib.at_edit_scores, lib.at_fit_scores):
            fn.restype = ctypes.c_int
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


def _launch(kernel, lead, m_pad, n_pad, tensors, out):
    """Launch one kernel on the current stream; raise on a launch error."""
    B = out.shape[0]
    threads, wmax = launch_shape(n_pad)
    scratch = torch.empty((B, _NBUF[kernel], threads * wmax),
                          dtype=torch.float32, device=out.device)
    fn = getattr(_kernels(), f"at_{kernel}_scores")
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        err = fn(*lead, *(x.data_ptr() for x in tensors), out.data_ptr(),
                 scratch.data_ptr(), B, m_pad, n_pad, threads, wmax, stream)
    if err != 0:
        raise RuntimeError(f"{kernel} fill kernel launch failed: CUDA error "
                           f"{err}")
    launches[kernel] += 1
    return out


def scores(mode, m_pad, n_pad, qs, ts, ns, ms, params):
    """Score-only fill for global / local / overlap / edit (the
    counterpart of ``pallas_scores``). Returns (B,) float32, int32 for
    edit."""
    _check(m_pad, n_pad, qs, ts, ns, ms, params)
    if qs.device.type == "cpu":
        return scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, params)
    B = qs.shape[0]
    args = (qs, ts, ns, ms, params)
    if mode in ("global", "local"):
        out = torch.empty(B, dtype=torch.float32, device=qs.device)
        return _launch("affine", (int(mode == "local"),), m_pad, n_pad, args,
                       out)
    if mode == "overlap":
        out = torch.empty(B, dtype=torch.float32, device=qs.device)
        return _launch("overlap", (), m_pad, n_pad, args, out)
    if mode == "edit":
        out = torch.empty(B, dtype=torch.int32, device=qs.device)
        return _launch("edit", (), m_pad, n_pad, args, out)
    raise ValueError(f"unknown score mode {mode!r}")


def fit_scores(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms, params):
    """Fit-mode score fill (the counterpart of ``pallas_fit_scores``).
    Returns (B,) float32."""
    _check(m_pad, n_pad, qs, ts, ns, ms, params, allow)
    if qs.device.type == "cpu":
        return fit_scores_plain(use_jump, m_pad, n_pad, qs, ts, allow, ns, ms,
                                params)
    out = torch.empty(qs.shape[0], dtype=torch.float32, device=qs.device)
    return _launch("fit", (int(bool(use_jump)),), m_pad, n_pad,
                   (qs, ts, allow, ns, ms, params), out)

"""Column-blocked DP fills for long targets: the CUDA kernels' wrappers.

Counterpart of ``aligntools_tpu/ops/pallas_blocked.py``: ``blocked_scores``
(the Pallas ``_blocked_affine_kernel``, all five modes) and
``blocked_ptr_fill`` (``_blocked_ptr_kernel``: global, local, fit(+jump),
overlap), with the JAX entries' argument layout (``ops/scan.py``'s, plus
the column block ``c_blk``; ``n_pad % c_blk == 0``) and outputs:

  blocked_scores    (B,) float32, int32 for edit
  blocked_ptr_fill  (score, a, b, ptrs) in ``ops/ptr.py``'s layout: ptrs
                    (B, m_pad / rpb, n_pad) uint8, columns 1..n_pad, every
                    byte written

Streaming the target in column blocks changes where the DP state lives,
not what is computed: the blocked Pallas kernels give the flat ones'
scores, start info and every pointer byte on the same inputs, pad rows and
pad columns included. So the plain versions are the flat fills' own
(``scan.scores_plain``, ``scan.fit_scores_plain``, ``ptr.ptr_fill_plain``),
and the results do not depend on ``c_blk``.

On a CUDA tensor the wrappers launch ``csrc/blocked_fill.cu`` (one CTA per
pair walking the column blocks in order, the row state of a block in
shared memory; see its header) or raise; on a CPU tensor they run the
plain versions.
"""

from __future__ import annotations

import ctypes

import torch

from aligntools_tpu_torch.ops import ptr, scan

# the kernels' column block on the H100: the widest divisor of 16384 whose
# row state and pointer staging fit one CTA's shared memory (fit+jump's
# pointer fill: 26 bytes a column, 208 KiB at 8192)
C_BLK = 8192
SCORE_MODES = ("global", "local", "fit", "overlap", "edit")

# launches of each kernel through its wrapper, and wrapper calls that ran
# the plain versions (on a CPU tensor)
launches = {"blocked_scores": 0, "blocked_ptr": 0}
plain_calls = 0


def reset_counts() -> None:
    global plain_calls
    for k in launches:
        launches[k] = 0
    plain_calls = 0


def _check_blocks(n_pad, c_blk):
    if c_blk <= 0 or c_blk % 16 or n_pad % c_blk:
        raise ValueError(f"c_blk {c_blk} must be a positive multiple of 16 "
                         f"that divides n_pad {n_pad}")


_fns = None


def _kernels():
    """(scores, pointer fill) C entry points with their signatures."""
    global _fns
    if _fns is None:
        from aligntools_tpu_torch.ops import _build

        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        # mode, use_jump, qs, ts, allow, ns, ms, params, out, edges, B,
        # m_pad, n_pad, c_blk, threads, wmax, stream
        lib.at_blocked_scores.argtypes = [I, I, P, P, P, P, P, P, P, P, I, I,
                                          I, I, I, I, P]
        # mode, use_jump, rpb, qs, ts, allow, ns, ms, params, score, a, b,
        # ptrs, edges, B, m_pad, n_pad, c_blk, threads, wmax, stream
        lib.at_blocked_ptr_fill.argtypes = [I, I, I, P, P, P, P, P, P, P, P,
                                            P, P, P, I, I, I, I, I, I, P]
        for fn in (lib.at_blocked_scores, lib.at_blocked_ptr_fill):
            fn.restype = ctypes.c_int
        _fns = (lib.at_blocked_scores, lib.at_blocked_ptr_fill)
    return _fns


def _edges(B, m_pad, device):
    """Block-edge state: per pair, two buffers (read / written, by block
    parity) of four states for rows 0..m_pad."""
    return torch.empty((B, 2, 4, m_pad + 1), dtype=torch.float32,
                       device=device)


def _launch(name, fn, args, device):
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    launches[name] += 1


def blocked_scores(mode, use_jump, m_pad, n_pad, c_blk, qs, ts, allow, ns,
                   ms, params):
    """Score-only blocked fill (the counterpart of the JAX
    ``blocked_scores``). ``allow`` (B, n_pad) float32 gates fit's jump
    entry and may be None without ``use_jump``. Returns (B,) float32,
    int32 for edit."""
    global plain_calls
    if mode not in SCORE_MODES:
        raise ValueError(f"unknown score mode {mode!r}")
    if use_jump and (mode != "fit" or allow is None):
        raise ValueError("the jump state exists in fit mode only, and needs "
                         "allow")
    _check_blocks(n_pad, c_blk)
    scan._check(m_pad, n_pad, qs, ts, ns, ms, params, allow)
    if qs.device.type == "cpu":
        plain_calls += 1
        if mode == "fit":
            return scan.fit_scores_plain(use_jump, m_pad, n_pad, qs, ts,
                                         allow, ns, ms, params)
        return scan.scores_plain(mode, m_pad, n_pad, qs, ts, ns, ms, params)
    B, dev = qs.shape[0], qs.device
    out = torch.empty(B, dtype=torch.int32 if mode == "edit"
                      else torch.float32, device=dev)
    threads, wmax = scan.launch_shape(c_blk)
    edges = _edges(B, m_pad, dev)
    _launch("blocked_scores", _kernels()[0], (
        SCORE_MODES.index(mode), int(bool(use_jump)), qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), out.data_ptr(),
        edges.data_ptr(), B, m_pad, n_pad, c_blk, threads, wmax), dev)
    return out


def blocked_ptr_fill(mode, use_jump, m_pad, n_pad, c_blk, qs, ts, allow, ns,
                     ms, params, rows_per_byte=1):
    """Blocked fill with packed pointer emission (the counterpart of the
    JAX ``blocked_ptr_fill``); returns (score, a, b, ptrs) as
    ``ops/ptr.py`` lays them out. Needs m_pad % (8 * rows_per_byte) == 0,
    as the Pallas kernel does."""
    global plain_calls
    rpb = rows_per_byte
    ptr._check(mode, use_jump, m_pad, n_pad, rpb, qs, ts, allow, ns, ms,
               params)
    _check_blocks(n_pad, c_blk)
    if m_pad % (8 * rpb):
        raise ValueError(f"m_pad {m_pad} is not a multiple of 8 * "
                         f"rows_per_byte {rpb}")
    if qs.device.type == "cpu":
        plain_calls += 1
        return ptr.ptr_fill_plain(mode, use_jump, m_pad, n_pad, qs, ts, allow,
                                  ns, ms, params, rpb)
    B, dev = qs.shape[0], qs.device
    score = torch.empty(B, dtype=torch.float32, device=dev)
    a = torch.empty(B, dtype=torch.int32, device=dev)
    b = torch.empty(B, dtype=torch.int32, device=dev)
    ptrs = torch.empty((B, m_pad // rpb, n_pad), dtype=torch.uint8,
                       device=dev)
    threads, wmax = scan.launch_shape(c_blk)
    edges = _edges(B, m_pad, dev)
    _launch("blocked_ptr", _kernels()[1], (
        ptr.MODES.index(mode), int(bool(use_jump)), rpb, qs.data_ptr(),
        ts.data_ptr(), 0 if allow is None else allow.data_ptr(),
        ns.data_ptr(), ms.data_ptr(), params.data_ptr(), score.data_ptr(),
        a.data_ptr(), b.data_ptr(), ptrs.data_ptr(), edges.data_ptr(), B,
        m_pad, n_pad, c_blk, threads, wmax), dev)
    return score, a, b, ptrs

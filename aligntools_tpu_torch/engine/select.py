"""Route selection: the one place the port's routes read their crossovers.

Counterpart of ``aligntools_tpu/engine/select.py``. Each route reads the
active crossover table (``engine/autotune.table()``: the card's calibrated
table, measured by ``aligntools-torch calibrate``, else the defaults, which
are the constants chip runs on one H100 picked):

  score_flat_cap(mode)      the widest target (n_pad) the register-strip
                            score fill of ``mode`` takes, per family:
                            affine (global, local, fit, fit+jump), overlap,
                            edit; wider ones go to the blocked score fill
                            (``ops/scan.blocked_c_blk``)
  ptr_flat_cap(f64)         the same for the flat pointer fill, float32 and
                            the double instances (``ops/ptr.blocked_c_blk``)
  blocked_c_blk(f64)        the blocked fills' column block
  banded_path(band, batch)  the banded fill's path, "warp" or "cta", by
                            the threshold of the band's warp strip
                            (``ops/banded._launch``)

A table value outside its kernel's structural range (``problem``) is
refused when written (``autotune.calibrate``, ``autotune.set_table``) and
ignored, with one stderr line, when read. Every route is bit-equal, so a
table changes times and never a result.
"""

from __future__ import annotations

import os
import sys

# the env override of the blocked fills' column block (the JAX package's
# variable, read first as aligntools_tpu/engine/select.py reads it)
CBLK_ENV = "ALIGNTOOLS_BLOCKED_CBLK"
# the batch path's bucket n_pad grid above 32,768 columns
# (batch.BLOCKED_C_BLK): a column block divides it
BUCKET_C_BLK = 16384


def family(mode: str) -> str:
    """The score-fill family of ``mode`` (fit+jump is fit's): the keys of
    ``score_flat_cap``."""
    if mode in ("edit", "overlap"):
        return mode
    return "affine"


def limits() -> dict:
    """The structural maxima of the flat caps: threads_max x W of each
    register-strip instance."""
    from aligntools_tpu_torch.ops import ptr, scan

    flat = ptr.MAX_THREADS * ptr.WIDTH
    return {"score_flat_cap": {"affine": flat, "overlap": flat,
                               "edit": scan.EDIT_MAX_THREADS * ptr.WIDTH},
            "ptr_flat_cap": {"float32": flat,
                             "float64": ptr.MAX_THREADS * ptr.WIDTH64}}


def problem(key: str, value) -> str | None:
    """Why ``value`` cannot stand for ``key`` (a leaf such as
    "score_flat_cap.edit", "blocked_c_blk" or "banded_bmin.16"), or None: a
    flat cap is a positive multiple of 128 up to its instance's threads_max
    x W; a column block divides BUCKET_C_BLK, is a multiple of 16 and at
    most blocked.C_BLK_MAX; banded_bmin, keyed by a warp strip of
    ops/banded.WARP_STRIPS, is a non-negative int."""
    from aligntools_tpu_torch.engine import autotune
    from aligntools_tpu_torch.ops import banded, blocked

    head, _, leaf = key.partition(".")
    if isinstance(autotune.DEFAULTS.get(head), dict) and not leaf:
        return (f"{key} = {value!r} is not a table of "
                f"{', '.join(autotune.DEFAULTS[head])}")
    if not isinstance(value, int) or isinstance(value, bool):
        return f"{key} = {value!r} is not an int"
    if head in ("score_flat_cap", "ptr_flat_cap"):
        top = limits()[head].get(leaf)
        if top is None:
            return f"{key} is not a key of the table"
        if not 0 < value <= top or value % 128:
            return (f"{key} = {value} is outside (0, {top}] or not a "
                    f"multiple of 128")
        return None
    if head == "blocked_c_blk":
        if (value <= 0 or value % 16 or BUCKET_C_BLK % value
                or value > blocked.C_BLK_MAX):
            return (f"{key} = {value} does not divide {BUCKET_C_BLK}, is not "
                    f"a multiple of 16 or is past C_BLK_MAX "
                    f"{blocked.C_BLK_MAX}")
        return None
    if head == "banded_bmin":
        if leaf not in map(str, banded.WARP_STRIPS):
            return f"{key} is not a key of the table"
        return None if value >= 0 else f"{key} = {value} is negative"
    return f"{key} is not a key of the table"


_warned: set = set()


def _warn(msg: str) -> None:
    """One stderr line for each message (a route reads per bucket)."""
    if msg not in _warned:
        _warned.add(msg)
        sys.stderr.write(f"[select] ignored: {msg}\n")


def _table() -> dict:
    from aligntools_tpu_torch.engine import autotune

    return autotune.table()


def score_flat_cap(mode: str) -> int:
    """The widest n_pad the register-strip score fill of ``mode`` takes in
    float32 (int32 for edit)."""
    return _table()["score_flat_cap"][family(mode)]


def ptr_flat_cap(f64: bool = False) -> int:
    """The widest n_pad the flat pointer fill takes: float32's, or the
    double instances' with ``f64``."""
    return _table()["ptr_flat_cap"]["float64" if f64 else "float32"]


def blocked_c_blk(f64: bool = False) -> int:
    """The blocked fills' column block: ALIGNTOOLS_BLOCKED_CBLK (at least
    128, as the JAX package reads it), then the table. With ``f64`` (the
    double instances) at most ``blocked.C_BLK_MAX64``, whose row state
    fits a CTA's shared memory."""
    from aligntools_tpu_torch.ops import blocked

    c_blk = _table()["blocked_c_blk"]
    env = os.environ.get(CBLK_ENV)
    if env:
        try:
            want = max(128, int(env))
        except ValueError:
            want = env
        why = problem("blocked_c_blk", want)
        if why:
            _warn(f"{CBLK_ENV}: {why}")
        else:
            c_blk = want
    return min(c_blk, blocked.C_BLK_MAX64) if f64 else c_blk


def banded_path(band: int, batch: int) -> str:
    """The banded fill's path for ``batch`` pairs at ``band``: "warp" (a
    warp a pair) where its window fits a warp strip and the batch reaches
    the table's banded_bmin for that strip, else "cta" (a CTA a pair)."""
    from aligntools_tpu_torch.ops import banded

    path, _, strip = banded.launch_shape(band)
    if path != "warp":
        return "cta"
    return "warp" if batch >= _table()["banded_bmin"][str(strip)] else "cta"

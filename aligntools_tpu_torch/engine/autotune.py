"""The card's crossover table: measured by ``calibrate``, cached per card.

Counterpart of ``aligntools_tpu/engine/autotune.py``. ``engine/select.py``
routes each bucket by this table; ``table()`` is the cached JSON for this
card (``$ALIGNTOOLS_TORCH_CACHE``, default ``~/.cache/aligntools-torch``,
``autotune_<slug of torch.cuda.get_device_name()>.json``), else DEFAULTS:
the constants chip runs on one H100 picked (PERF.md), so a machine that
never ran ``calibrate`` routes as before. Keys, each the port's
counterpart of a JAX stage, measured at the shape named:

  score_flat_cap  per family (affine: global, local, fit, fit+jump; overlap;
                  edit): the register-strip score fill against the blocked
                  one at 64 x 512 rows from 4,224 columns to the flat
                  kernel's widest; the widest n_pad up to which the flat
                  fill wins at every width swept (the JAX ``bmin`` /
                  ``nmax``: the engine by shape)
  ptr_flat_cap    float32 and the double instances: the flat pointer fill
                  against the blocked one at 128 x 512 local (rpb 2) and 64
                  x 512 fit+jump (rpb 1), the same rule
  blocked_c_blk   the column block, 1,024 to 8,192, at 8 ragged pairs in
                  1,024 x 65,536, the score and pointer fills summed: the
                  fastest (the JAX stage 9)
  banded_bmin     per warp strip (5, 9 and 16 lanes a thread): the banded
                  fill's warp path against its CTA path at one band of
                  that strip (W 64, 128 and 200), 1,024 rows, 64 to 2,112
                  pairs: the smallest batch from which the warp path wins
                  at every batch swept, 0 where it wins at the smallest
                  (the JAX ``banded_bmin``)

The JAX table's other keys route to engines or options the port does not
have (ROADMAP.md, queue 1, item 9). ``calibrate`` writes the table with its
timings under "measured", atomically (a temporary file, then a rename); it
raises without a usable Hopper card. Timing: CUDA events, K2 launches less
K1's over K2 - K1, REPEATS times a kernel a point; a point keeps the
medians and its spread, the two kernels' ranges summed. A key moves off its
default only where the alternative wins by more than the spread at that
point, so a near tie keeps the default.
"""

from __future__ import annotations

import copy
import json
import os
import re
import sys
import time

CACHE_ENV = "ALIGNTOOLS_TORCH_CACHE"
# blocked_c_blk's 2,048 was the fastest of 8,192, 4,096 and 2,048 on the
# reference fixture's shape, on long-target read sets and on P3 (64 x 512 x
# 32,768 fit+jump; chip_smoke.py's blocked, long and ptr phases; PERF.md):
# narrower blocks put more CTAs, and more of them an SM, in flight
DEFAULTS = {
    "score_flat_cap": {"affine": 8192, "overlap": 8192, "edit": 16384},
    "ptr_flat_cap": {"float32": 8192, "float64": 4096},
    "blocked_c_blk": 2048,
    "banded_bmin": {"5": 0, "9": 0, "16": 0},
}
# what calibrate sweeps (see the module docstring)
SCORE_SHAPE = (64, 512)
SCORE_VARIANTS = {"affine": ("global", "local", "fit", "fit+jump"),
                  "overlap": ("overlap",), "edit": ("edit",)}
SCORE_N_PADS = {"affine": (4224, 6144, 8192), "overlap": (4224, 6144, 8192),
                "edit": (4224, 8192, 12288, 16384)}
PTR_CASES = ((128, 512, "local", False, 2), (64, 512, "fit", True, 1))
PTR_N_PADS = {"float32": (4224, 6144, 8192), "float64": (2176, 3072, 4096)}
C_BLK_SHAPE = (8, 1024, 65536)
C_BLKS = (1024, 2048, 4096, 8192)
# one band a warp strip (ops/banded.WARP_STRIPS), the strip's key
BANDED_BANDS = {"5": 64, "9": 128, "16": 200}
BANDED_ROWS = 1024
BANDED_BATCHES = (64, 256, 1024, 2112)
# timings a kernel a point, and the launches each is the difference of
REPEATS, K1, K2 = 5, 2, 10

_active: dict | None = None


def device_kind() -> str | None:
    """The card's name, or None where this process has not initialised
    CUDA (no card, or a run on the CPU): then no cache is read, and no
    CUDA context is made only to name the card."""
    import torch

    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return None
    return torch.cuda.get_device_name(0)


def cache_path(kind: str) -> str:
    base = os.environ.get(CACHE_ENV) or os.path.expanduser(
        "~/.cache/aligntools-torch")
    slug = re.sub(r"[^A-Za-z0-9._-]+", "_", kind)
    return os.path.join(base, f"autotune_{slug}.json")


def _leaves(t: dict):
    """(dotted key, value) of every routed value of a table; a key whose
    default is a table but whose value is not, whole (``select.problem``
    refuses it)."""
    for key, default in DEFAULTS.items():
        value = t.get(key)
        if isinstance(default, dict) and isinstance(value, dict):
            for leaf in default:
                yield f"{key}.{leaf}", value.get(leaf)
        else:
            yield key, value


def merged(raw: dict, source: str) -> dict:
    """DEFAULTS overlaid with each valid value of ``raw``; a value outside
    its kernel's range is ignored with one stderr line."""
    from aligntools_tpu_torch.engine import select

    out = copy.deepcopy(DEFAULTS)
    for key, value in _leaves(raw):
        if value is None:
            continue
        why = select.problem(key, value)
        if why:
            sys.stderr.write(f"[autotune] {source}: ignored {why}\n")
            continue
        head, _, leaf = key.partition(".")
        if leaf:
            out[head][leaf] = value
        else:
            out[head] = value
    for extra in ("device_kind", "measured", "seconds"):
        if extra in raw:
            out[extra] = raw[extra]
    return out


def table() -> dict:
    """The active crossover table: the one ``set_table`` put, else this
    card's cached one, else DEFAULTS (not kept while the process has no
    card, so that the card's table is read once it has one)."""
    global _active
    if _active is None:
        kind = device_kind()
        if kind is None:
            return DEFAULTS
        path = cache_path(kind)
        raw = {}
        if os.path.exists(path):
            try:
                with open(path) as f:
                    raw = json.load(f)
            except (OSError, ValueError) as err:
                sys.stderr.write(f"[autotune] {path}: ignored ({err})\n")
        _active = merged(raw if isinstance(raw, dict) else {}, path)
    return _active


def set_table(t: dict | None) -> dict | None:
    """Make ``t`` the active table (None: read the cache again at the next
    ``table()``); a value outside its kernel's range raises. Returns the
    table that was active."""
    global _active
    from aligntools_tpu_torch.engine import select

    if t is not None:
        for key, value in _leaves(t):
            why = value is not None and select.problem(key, value)
            if why:
                raise ValueError(f"refused: {why}")
        t = merged(t, "set_table")
    was, _active = _active, t
    return was


# ---------------------------------------------------------------------------
# The crossover choices: pure functions of the timings
# ---------------------------------------------------------------------------


def _loses(point) -> bool:
    """(time kept, time of the alternative[, spread]): the alternative
    wins by more than the spread (0 where none is given)."""
    kept, other, spread = (*point, 0.0)[:3]
    return kept - other > spread


def flat_cap_from(timings: dict) -> int:
    """{n_pad: (flat s, blocked s[, spread s])} -> the widest n_pad up to
    which the blocked fill beats the flat one by no more than the spread
    at every width swept; where it does at the narrowest, the 128-column
    grid point below it."""
    cap = None
    for n_pad in sorted(timings):
        if _loses(timings[n_pad]):
            break
        cap = n_pad
    return cap if cap is not None else min(timings) - 128


def fastest(timings: dict, default=None) -> int:
    """{value: s or (s, range s)} -> the value of the least time (the
    smaller on a tie); ``default`` where the fastest beats it by no more
    than the two ranges summed."""
    t = {k: (v, 0.0) if isinstance(v, (int, float)) else tuple(v)
         for k, v in timings.items()}
    best = min(sorted(t), key=lambda k: t[k][0])
    if default in t and not _loses((t[default][0], t[best][0],
                                    t[default][1] + t[best][1])):
        return default
    return best


def bmin_from(timings: dict) -> int:
    """{batch: (warp s, cta s[, spread s])} -> the smallest batch from
    which the CTA path beats the warp path by no more than the spread at
    every batch swept: 0 where that is the smallest batch swept, one past
    the largest where it does at none."""
    batches = sorted(timings)
    bmin = batches[-1] + 1
    for batch in reversed(batches):
        if _loses(timings[batch]):
            break
        bmin = batch
    return 0 if bmin == batches[0] else bmin


# ---------------------------------------------------------------------------
# Measurement on the card
# ---------------------------------------------------------------------------


def _samples(launch) -> list:
    """REPEATS timings, in seconds, of one launch of ``launch``: CUDA
    events around K2 launches less K1's, over K2 - K1, after K2 launches
    to warm up."""
    from aligntools_tpu_torch.tools.vpu_probe import _event_seconds

    def run(K):
        for _ in range(K):
            launch()

    run(K2)
    return [(_event_seconds(lambda: run(K2)) - _event_seconds(lambda: run(K1)))
            / (K2 - K1) for _ in range(REPEATS)]


def _median(xs) -> float:
    return sorted(xs)[len(xs) // 2]


def _spread(xs) -> float:
    return max(xs) - min(xs)


def _pair(kept, other) -> tuple:
    """Two launches timed at one point: (median of ``kept``, median of
    ``other``, spread), the spread the two ranges summed."""
    a, b = _samples(kept), _samples(other)
    return _median(a), _median(b), _spread(a) + _spread(b)


def _ms(point) -> str:
    return "  ".join(f"{x * 1e3:8.4f}" for x in point) + " ms"


def _inputs(B, m_pad, n_pad, seed, dtype, ragged=False):
    """Seeded kernel inputs on the card (full or ragged lengths, allow
    closed at 5% of the columns) and the params row in ``dtype``."""
    import numpy as np
    import torch

    from aligntools_tpu_torch.convert import params_matrix
    from aligntools_tpu_torch.params import AlignParams

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8).astype(np.int32)
    if ragged:
        ms = rng.integers(m_pad // 2, m_pad + 1, B)
        ns = np.maximum(rng.integers(n_pad // 2, n_pad + 1, B), ms)
    else:
        ms, ns = np.full(B, m_pad), np.full(B, n_pad)
    qs = np.where(np.arange(m_pad) < ms[:, None],
                  rng.choice(alpha, (B, m_pad)), -1)
    ts = np.where(np.arange(n_pad) < ns[:, None],
                  rng.choice(alpha, (B, n_pad)), -2)
    allow = (rng.random((B, n_pad)) >= 0.05).astype(np.float32)

    def put(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).cuda()

    return (put(qs, np.int32), put(ts, np.int32), put(allow, np.float32),
            put(ns[:, None], np.int32), put(ms[:, None], np.int32),
            params_matrix(AlignParams(), "cuda", dtype))


def _score_fill(variant, m_pad, n_pad, args, c_blk):
    from aligntools_tpu_torch.ops import blocked, scan

    qs, ts, allow, ns, ms, pm = args
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    if c_blk:
        return lambda: blocked.blocked_scores(mode, jump, m_pad, n_pad, c_blk,
                                              qs, ts, allow if jump else None,
                                              ns, ms, pm)
    if mode == "fit":
        return lambda: scan._launch_strip("fit", jump, m_pad, n_pad, qs, ts,
                                          allow, ns, ms, pm)
    return lambda: scan._launch_strip(mode, False, m_pad, n_pad, qs, ts, None,
                                      ns, ms, pm)


def _ptr_fill(mode, jump, rpb, m_pad, n_pad, args, c_blk):
    from aligntools_tpu_torch.ops import blocked, ptr

    qs, ts, allow, ns, ms, pm = args
    allow = allow if jump else None
    if c_blk:
        return lambda: blocked.blocked_ptr_fill(mode, jump, m_pad, n_pad,
                                                c_blk, qs, ts, allow, ns, ms,
                                                pm, rpb)
    return lambda: ptr._launch(mode, jump, m_pad, n_pad, rpb,
                               (qs, ts, allow, ns, ms, pm),
                               ptr.launch_shape(n_pad, pm.dtype))


def _banded_inputs(B, L, band, seed):
    """B similar pairs of L bases (the target the query with 1%
    substitutions) in the banded kernel's layout."""
    import numpy as np
    import torch

    from aligntools_tpu_torch.convert import params_matrix
    from aligntools_tpu_torch.params import AlignParams

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8).astype(np.int32)
    qs = rng.choice(alpha, (B, L))
    ts = qs.copy()
    mut = rng.random((B, L)) < 0.01
    ts[mut] = rng.choice(alpha, int(mut.sum()))
    te = np.full((B, band + L + 2 * band + 2), -2, np.int32)
    te[:, band : band + L] = ts
    lens = np.full((B, 1), L, np.int32)

    def put(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    return (put(qs), put(te), put(lens), put(lens),
            params_matrix(AlignParams(), "cuda"))


def _measure(log) -> dict:
    """Every key on the card: (the table, its timings in seconds: each
    point's medians and spread)."""
    import torch

    from aligntools_tpu_torch.engine import select
    from aligntools_tpu_torch.ops import banded

    top = select.limits()
    result = {"score_flat_cap": {}, "ptr_flat_cap": {}, "banded_bmin": {}}
    measured = {key: {} for key in DEFAULTS}
    B, m_pad = SCORE_SHAPE
    c_own = DEFAULTS["blocked_c_blk"]
    log("# point: flat, blocked, spread (score and pointer caps); scores, "
        "pointers, spread (c_blk); warp, cta, spread (banded)")
    for fam, variants in SCORE_VARIANTS.items():
        caps = []
        for variant in variants:
            t = {}
            for n_pad in SCORE_N_PADS[fam]:
                args = _inputs(B, m_pad, n_pad, 7, torch.float32)
                t[n_pad] = _pair(
                    _score_fill(variant, m_pad, n_pad, args, None),
                    _score_fill(variant, m_pad, n_pad, args, c_own))
                log(f"  score {variant:8s} {B}x{m_pad}x{n_pad:5d}: "
                    f"{_ms(t[n_pad])}")
            measured["score_flat_cap"][variant] = {
                str(k): list(v) for k, v in t.items()}
            caps.append(flat_cap_from(t))
        result["score_flat_cap"][fam] = min(min(caps),
                                            top["score_flat_cap"][fam])
    for key, dtype in (("float32", torch.float32),
                       ("float64", torch.float64)):
        caps = []
        for B, m_pad, mode, jump, rpb in PTR_CASES:
            t = {}
            label = f"{mode}{'+jump' if jump else ''}/rpb{rpb}"
            for n_pad in PTR_N_PADS[key]:
                args = _inputs(B, m_pad, n_pad, 11, dtype, ragged=True)
                c_blk = select.blocked_c_blk(key == "float64")
                t[n_pad] = _pair(
                    _ptr_fill(mode, jump, rpb, m_pad, n_pad, args, None),
                    _ptr_fill(mode, jump, rpb, m_pad, n_pad, args, c_blk))
                log(f"  ptr {key} {label:13s} {B}x{m_pad}x{n_pad:5d}: "
                    f"{_ms(t[n_pad])}")
                del args
            measured["ptr_flat_cap"][f"{key}/{label}"] = {
                str(k): list(v) for k, v in t.items()}
            caps.append(flat_cap_from(t))
        result["ptr_flat_cap"][key] = min(min(caps), top["ptr_flat_cap"][key])
    B, m_pad, n_pad = C_BLK_SHAPE
    args = _inputs(B, m_pad, n_pad, 13, torch.float32, ragged=True)
    t = {}
    for c_blk in C_BLKS:
        s = _samples(_score_fill("local", m_pad, n_pad, args, c_blk))
        p = _samples(_ptr_fill("local", False, 2, m_pad, n_pad, args, c_blk))
        point = (_median(s), _median(p), _spread(s) + _spread(p))
        t[c_blk] = (point[0] + point[1], point[2])
        log(f"  blocked c_blk {c_blk:4d} at {B}x{m_pad}x{n_pad}: "
            f"{_ms(point)}")
        measured["blocked_c_blk"][str(c_blk)] = list(point)
    del args
    result["blocked_c_blk"] = fastest(t, c_own)
    for strip, band in BANDED_BANDS.items():
        shapes = (banded.launch_shape(band), banded.cta_shape(band))
        t = {}
        for batch in BANDED_BATCHES:
            qs, te, ns, ms, pm = _banded_inputs(batch, BANDED_ROWS, band, 17)
            t[batch] = _pair(*(
                lambda s=s: banded._launch("local", True, band, qs, te, ns,
                                           ms, pm, s) for s in shapes))
            log(f"  banded W {band} (strip {strip}) {batch:4d} x "
                f"{BANDED_ROWS}: {_ms(t[batch])}")
            del qs, te
        measured["banded_bmin"][strip] = {str(k): list(v)
                                          for k, v in t.items()}
        result["banded_bmin"][strip] = bmin_from(t)
    torch.cuda.empty_cache()
    return result, measured


def calibrate(force: bool = False, log=print) -> dict:
    """Measure the crossover table on the card and cache it; returns the
    table. Returns the cached table unless ``force`` or none exists. Raises
    without a usable Hopper card."""
    global _active
    from aligntools_tpu_torch.backend import resolve_device
    from aligntools_tpu_torch.engine import select

    resolve_device("cuda", cpu_hint="calibrate measures the card")
    kind = device_kind()
    path = cache_path(kind)
    if not force and os.path.exists(path):
        _active = None
        log(f"cached table for {kind}: {path} (--force measures again)")
        return table()
    t0 = time.perf_counter()
    log(f"# calibrating {kind}")
    result, measured = _measure(log)
    for key, value in _leaves(result):
        why = select.problem(key, value)
        if why:
            raise RuntimeError(f"calibrate measured a value outside its "
                               f"kernel's range: {why}")
    result = {"device_kind": kind, **result, "measured": measured,
              "seconds": time.perf_counter() - t0}
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(result, f, indent=1)
    os.replace(tmp, path)
    _active = None
    log(f"calibrated {kind} in {result['seconds']:.1f} s: score_flat_cap "
        f"{result['score_flat_cap']}, ptr_flat_cap {result['ptr_flat_cap']}, "
        f"blocked_c_blk {result['blocked_c_blk']}, banded_bmin "
        f"{result['banded_bmin']} -> {path}")
    return table()

"""Randomized differential campaign: the port against the native C++ CLI.

Port of ``tools/validate.py``. Thousands of randomized pairs (uniform DNA,
tie-heavy binary alphabets, homopolymer runs, protein, degenerate parameter
sets: match == mismatch, o == e, everything -1) go through the port's entry
points on one device, and each result is held against the stdout of the
repository's native single-pair CLI (``native/aligntools_cli.cpp``, built
by ``native.cli_binary``), which computes the reference's recurrences in
double: scores always, alignment rows wherever its rows are self-consistent
(``rows_sane``, which the JAX tool needs for the reference's strrev
overflow). Sections:

  main         ``api.align_pair`` per case; then, grouped by parameter set
               (fit also by the jump state), ``batch.batch_scores`` and
               ``batch.align_batch`` over the first 60 cases: ragged
               buckets that a batch of one never takes
  native-cli   the per-mode commands (``cli.main``, in this process): their
               stdout bytes and exit code equal the native CLI's on the same
               command (overlap's argv[1] quirk, ``fit -s`` included)
  rescan       ``engine/rescan.rescan_align`` at strides 8, 16 and 24
  banded-full  ``engine/banded.banded_align_batch`` at a band that covers
               the matrix (the warp path) and at max(that, 256) (the CTA
               path)
  banded-auto  ``banded_score_auto``: certified, and the exact score
  seqpar       ``parallel/seqpar.seqpar_align`` and ``seqpar_score`` on
               D = 4 and 8 in-process column slices (``loopback``)
  routes       pairs whose target width sits at and one 128-column quantum
               past each crossover of the table in force
               (``select.score_flat_cap``, ``ptr_flat_cap``, 4 x
               ``blocked_c_blk``), scores and rows in batches

Every port call runs in this process (a fresh interpreter pays for ``import
torch``); only the native CLI runs as a subprocess. A mismatch raises
``Mismatch``, naming the section, mode, case, seed, lengths and parameters,
and the command exits 1. The last line of stdout is one JSON object: each
section's cases, skips and seconds and, on the card, each kernel's launches
over the run.

    python3 -m aligntools_tpu_torch.tools.validate [n_per] [--section S]
        [--device cuda|cpu]

``n_per`` (default 120) is the cases a mode of ``main``; the other
sections scale from it as the JAX tool's do. The default device is the
card; ``--device cpu`` runs the kernels' plain versions.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from aligntools_tpu_torch.params import AlignParams

MODES = ("global", "local", "edit", "fit", "overlap")
ROWS_MODES = ("global", "local", "fit", "overlap")
# the JAX tool's seeds, one a section (routes: the port's own)
SEEDS = {"main": 2026, "native-cli": 83, "rescan": 31, "banded-full": 77,
         "banded-auto": 47, "seqpar": 59, "routes": 113}
BATCH_CASES = 60  # main: the cases a mode that also run in batches
STRIDES = (8, 16, 24)
SEQPAR_RANKS = (4, 8)
CTA_BAND = 256  # the narrowest band past the warp path's 512 lanes
# a band past the 8,191 the CTA path once capped (a cluster of CTAs a
# pair), for the first WIDE_CASES pairs of each mode
WIDE_BAND = 9000
WIDE_CASES = 4
ROUTE_M = (256, 512)
QUANTUM = 128  # the batch path's n_pad step (batch._align_n)


class Mismatch(AssertionError):
    """A result of the port that differs from the native CLI's."""


# --------------------------------------------------------------------------
# Copied from tools/validate.py (which imports the JAX package)
# --------------------------------------------------------------------------


def gen_seq(rng, kind, lo, hi):
    """A random sequence of ``kind`` and a length in [lo, hi] (copied from
    ``tools/validate.py:52``)."""
    n = int(rng.integers(lo, hi + 1))
    if kind == "dna":
        return bytes(rng.choice(list(b"ACGT"), n).tolist())
    if kind == "binary":
        return bytes(rng.choice(list(b"AB"), n).tolist())
    if kind == "protein":
        return bytes(rng.choice(list(b"ACDEFGHIKLMNPQRSTVWY"), n).tolist())
    if kind == "homopolymer":
        out = bytearray()
        while len(out) < n:
            out += bytes([rng.choice(list(b"ACGT"))]) * int(
                rng.integers(1, 12)
            )
        return bytes(out[:n])
    raise ValueError(kind)


# copied from tools/validate.py:70-76
PARAM_SETS = [
    dict(match=1, mismatch=-2, gap_open=-5, gap_extend=-1),   # defaults
    dict(match=2, mismatch=-3, gap_open=-4, gap_extend=-2),
    dict(match=1, mismatch=1, gap_open=-1, gap_extend=-1),    # m == u: ties
    dict(match=3, mismatch=0, gap_open=-2, gap_extend=-2),    # o == e
    dict(match=1, mismatch=-1, gap_open=-1, gap_extend=-1),   # everything -1
]


def rows_sane(r1, r2, q, t, mode):
    """Whether the rows are self-consistent: equal lengths, and without
    gaps the pair (global), the query and a part of the target (fit), or
    parts of both (copied from ``tools/validate.py:79``)."""
    if len(r1) != len(r2):
        return False
    u1, u2 = r1.replace("-", ""), r2.replace("-", "")
    if mode == "global":
        return u1 == q and u2 == t
    if mode == "fit":
        return u1 == q and u2 in t
    return u1 in q and u2 in t


# copied from tools/validate.py:90
KINDS = ["dna", "binary", "homopolymer", "protein"]


def gen_case(rng, mode, k, tmp, max_m=100, max_n=140, sites_ok=True):
    """One randomized case: (q, t, params, sites, fa_path, ref_cmd)
    (copied from ``tools/validate.py:105``, with the port's AlignParams)."""
    kind = KINDS[k % len(KINDS)]
    pd = PARAM_SETS[k % len(PARAM_SETS)]
    p = AlignParams(**pd)
    q = gen_seq(rng, kind, 1, max_m)
    t = gen_seq(rng, kind, len(q) if mode == "fit" else 1, max_n)
    if mode == "fit" and len(t) < len(q):
        t = t + gen_seq(rng, kind, len(q) - len(t), len(q) - len(t))
    sites = None
    fa = os.path.join(tmp, "pair.fa")
    hdr2 = ">t"
    args = []
    if mode == "fit" and k % 2 and sites_ok:
        sites = sorted(int(x) for x in rng.integers(0, len(t), 4))
        hdr2 = ">t " + "|".join(map(str, sites))
        args = ["-s"]
    with open(fa, "w") as f:
        f.write(f">q\n{q.decode()}\n{hdr2}\n{t.decode()}\n")
    if mode == "overlap":
        cmd = [mode, fa]  # argv[1] bug: no options possible
        p = AlignParams()
    elif mode == "edit":
        cmd = [mode, "-m", str(p.match), "-u", str(p.mismatch), fa]
    else:
        cmd = [mode, "-m", str(p.match), "-u", str(p.mismatch),
               "-o", str(p.gap_open), "-e", str(p.gap_extend), *args, fa]
    return q, t, p, sites, fa, cmd


def ref_score_rows(lines, mode):
    """(score, row1, row2 | None, None) from reference stdout lines (copied
    from ``tools/validate.py:137``)."""
    if mode == "edit":
        return float(lines[-1].split("=")[-1]), None, None
    score_line = (lines[0] if mode == "overlap" else
                  next(ln for ln in lines if ln.startswith("score=")))
    idx = lines.index(score_line)
    return (float(score_line.split("=")[-1]),
            lines[idx + 1], lines[idx + 2])


# --------------------------------------------------------------------------
# The oracle, the cases and the run's counters
# --------------------------------------------------------------------------


def pair_command(mode, q, t, p, sites, fa):
    """Write the pair to ``fa`` and return its command, as ``gen_case``
    does (overlap takes no options; ``p`` must be AlignParams() there)."""
    with open(fa, "w") as f:
        head = "" if sites is None else " " + "|".join(map(str, sites))
        f.write(f">q\n{q.decode()}\n>t{head}\n{t.decode()}\n")
    if mode == "overlap":
        return [mode, fa]
    if mode == "edit":
        return [mode, "-m", str(p.match), "-u", str(p.mismatch), fa]
    return [mode, "-m", str(p.match), "-u", str(p.mismatch), "-o",
            str(p.gap_open), "-e", str(p.gap_extend),
            *(["-s"] if sites is not None else []), fa]


class Oracle:
    """The native CLI as a subprocess: (stdout lines, exit code, stdout
    bytes) of a command, its stdout decoded as latin-1 (as the JAX tool's
    ``make_ref_runner`` decodes the reference's)."""

    def __init__(self, binary):
        self.binary = binary

    def __call__(self, cmd):
        r = subprocess.run([self.binary, *cmd], capture_output=True,
                           timeout=300)
        lines = [ln for ln in r.stdout.decode("latin-1").splitlines()
                 if ln != "asDAsdaSDAsdasDAsdaSD"]
        return lines, r.returncode, r.stdout


class Case:
    """One case of a section: what a mismatch names."""

    def __init__(self, section, mode, k, seed, q, t, p, sites=None,
                 cmd=None):
        self.section, self.mode, self.k, self.seed = section, mode, k, seed
        self.q, self.t, self.p, self.sites, self.cmd = q, t, p, sites, cmd
        self.score = self.row1 = self.row2 = None
        self.sane = False

    def fail(self, what):
        p = self.p
        raise Mismatch(
            f"[{self.section}] {self.mode} case {self.k} (seed {self.seed}, "
            f"m={len(self.q)}, n={len(self.t)}, params m={p.match} "
            f"u={p.mismatch} o={p.gap_open} e={p.gap_extend} j={p.jump}, "
            f"sites={self.sites}): {what}")

    def expect(self, got, want, what):
        if got != want:
            self.fail(f"{what}: the port gives {got!r}, the native CLI "
                      f"{want!r}")

    def expect_result(self, r, what):
        """``r`` (an AlignResult, or an int for edit) equals the oracle's
        score, and its rows the oracle's where those are sane."""
        if self.mode == "edit":
            self.expect(r, int(self.score), f"{what} distance")
            return
        self.expect(r.score, self.score, f"{what} score")
        if self.sane:
            self.expect((r.row1.decode("latin-1"), r.row2.decode("latin-1")),
                        (self.row1, self.row2), f"{what} rows")


class Run:
    """The campaign's state: device, oracle, scratch directory and the
    per-section counters."""

    def __init__(self, device, oracle, tmp, log):
        self.device, self.oracle, self.tmp, self.log = (device, oracle, tmp,
                                                        log)
        self.sections = {}
        self.stats = None
        self.current = None  # the case a port error is reported against

    def begin(self, name):
        self.current = None
        self.stats = self.sections[name] = {"cases": 0, "oracle_rc": 0,
                                            "rows_insane": 0}

    def ask(self, case):
        """Run the oracle on ``case``; False (a skip, counted) where it
        exits non-zero. Sets the case's score and rows."""
        self.current = case
        lines, rc, _ = self.oracle(case.cmd)
        if rc != 0:
            self.stats["oracle_rc"] += 1
            return False
        self.stats["cases"] += 1
        case.score, case.row1, case.row2 = ref_score_rows(lines, case.mode)
        if case.mode != "edit":
            case.sane = rows_sane(case.row1, case.row2, case.q.decode(),
                                  case.t.decode(), case.mode)
            self.stats["rows_insane"] += not case.sane
        return True

    def case(self, section, rng, mode, k, **kw):
        q, t, p, sites, _, cmd = gen_case(rng, mode, k, self.tmp, **kw)
        return Case(section, mode, k, SEEDS[section], q, t, p, sites, cmd)


# --------------------------------------------------------------------------
# Sections
# --------------------------------------------------------------------------


def section_main(run, n_per):
    from aligntools_tpu_torch import api, batch

    rng = np.random.default_rng(SEEDS["main"])
    for mode in MODES:
        done = []
        for k in range(n_per):
            c = run.case("main", rng, mode, k)
            if not run.ask(c):
                continue
            c.expect_result(api.align_pair(mode, c.q, c.t, c.p, c.sites,
                                           device=run.device), "align_pair")
            done.append(c)
        # batches of the first cases by parameter set, fit also by the jump
        # state (a batch takes one: sites None means no jump state)
        groups = {}
        for c in done[:BATCH_CASES]:
            groups.setdefault((c.p, c.sites is not None), []).append(c)
        for (p, jump), cs in groups.items():
            prs = [(c.q, c.t) for c in cs]
            sl = [c.sites for c in cs] if jump else None
            got = batch.batch_scores(mode, prs, p, sl, device=run.device)
            for c, s in zip(cs, got):
                c.expect(float(s), c.score, f"batch_scores of {len(cs)}")
            if mode != "edit":
                res = batch.align_batch(mode, prs, p, sl, traceback=True,
                                        device=run.device)
                for c, r in zip(cs, res):
                    c.expect_result(r, f"align_batch of {len(cs)}")
        run.log(f"main {mode}: OK ({len(done)}/{n_per} cases, "
                f"{len(groups)} batches)")


def port_cli(argv, device):
    """The port's command ``argv`` in this process on ``device``: (stdout
    bytes, exit code)."""
    from aligntools_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    was = os.environ.get(cli.DEVICE_ENV)
    os.environ[cli.DEVICE_ENV] = str(device)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(list(argv))
    finally:
        if was is None:
            del os.environ[cli.DEVICE_ENV]
        else:
            os.environ[cli.DEVICE_ENV] = was
    return out.getvalue().encode("latin-1"), rc


def section_native_cli(run, n_per):
    rng = np.random.default_rng(SEEDS["native-cli"])
    n = max(24, n_per // 2)
    for mode in MODES:
        for k in range(n):
            c = run.current = run.case("native-cli", rng, mode, k)
            _, rc, want = run.oracle(c.cmd)
            run.stats["cases"] += 1
            got, got_rc = port_cli(c.cmd, run.device)
            c.expect(got_rc, rc, f"exit code of {' '.join(c.cmd[:-1])}")
            c.expect(got, want, f"stdout of {' '.join(c.cmd[:-1])}")
        run.log(f"native-cli {mode}: OK ({n} commands, stdout and exit "
                f"code)")


def section_rescan(run, n_per):
    from aligntools_tpu_torch.engine import rescan

    rng = np.random.default_rng(SEEDS["rescan"])
    n = max(12, n_per // 8)
    for mode in ROWS_MODES:
        checked = 0
        for k in range(n):
            c = run.case("rescan", rng, mode, k)
            if not run.ask(c):
                continue
            S = STRIDES[k % len(STRIDES)]
            c.expect_result(rescan.rescan_align(mode, c.q, c.t, c.p, c.sites,
                                                stride=S, device=run.device),
                            f"rescan_align at stride {S}")
            checked += 1
        run.log(f"rescan {mode}: OK ({checked}/{n} cases, strides "
                f"{'/'.join(map(str, STRIDES))})")


def section_banded_full(run, n_per):
    from aligntools_tpu_torch.engine import banded, select

    rng = np.random.default_rng(SEEDS["banded-full"])
    for mode in ROWS_MODES:
        # the native CLI's overlap takes no options
        p = (AlignParams() if mode == "overlap" else
             AlignParams(match=2, mismatch=-2, gap_open=-4, gap_extend=-1))
        cases = []
        for k in range(max(20, n_per // 4)):
            kind = KINDS[k % len(KINDS)]
            q = gen_seq(rng, kind, 1, 80)
            t = gen_seq(rng, kind, 1, 100)
            if mode == "fit" and len(q) > len(t):
                q, t = t, q
            c = Case("banded-full", mode, k, SEEDS["banded-full"], q, t, p)
            c.cmd = pair_command(mode, q, t, p, None,
                                 os.path.join(run.tmp, "pair.fa"))
            if run.ask(c):
                cases.append(c)
        prs = [(c.q, c.t) for c in cases]
        full = max(max(len(q), len(t)) for q, t in prs)
        paths = []
        for band, some in ((full, cases), (max(full, CTA_BAND), cases),
                           (WIDE_BAND, cases[:WIDE_CASES])):
            paths.append(select.banded_path(band, len(some)))
            res, _ = banded.banded_align_batch(
                mode, [(c.q, c.t) for c in some], band, p, device=run.device)
            for c, r in zip(some, res):
                c.expect_result(r, f"banded_align_batch at band {band} "
                                   f"({paths[-1]} path)")
        run.log(f"banded-full {mode}: OK ({len(cases)} cases, bands {full} "
                f"and {max(full, CTA_BAND)}, {min(len(cases), WIDE_CASES)} "
                f"at {WIDE_BAND}: {' and '.join(paths)} paths)")


def section_banded_auto(run, n_per):
    from aligntools_tpu_torch.engine import banded

    rng = np.random.default_rng(SEEDS["banded-auto"])
    n = max(12, n_per // 8)
    for mode in MODES:
        bands = []
        for k in range(n):
            # the banded engine has no fit jump state: no sites here
            c = run.case("banded-auto", rng, mode, k, sites_ok=False)
            if not run.ask(c):
                continue
            score, band, cert = banded.banded_score_auto(
                mode, c.q, c.t, c.p, device=run.device)
            if not cert:
                c.fail(f"banded_score_auto uncertified at band {band}")
            c.expect(float(score), c.score, f"banded_score_auto score at "
                                            f"band {band}")
            bands.append(band)
        run.log(f"banded-auto {mode}: OK ({len(bands)}/{n} cases, final "
                f"bands {min(bands)}-{max(bands)})")


def section_seqpar(run, n_per):
    from aligntools_tpu_torch.parallel import seqpar

    rng = np.random.default_rng(SEEDS["seqpar"])
    n = max(8, n_per // 15)
    for mode in ROWS_MODES:
        checked = 0
        for k in range(n):
            c = run.case("seqpar", rng, mode, k, max_m=60, max_n=120)
            if not run.ask(c):
                continue
            D = SEQPAR_RANKS[k % len(SEQPAR_RANKS)]
            c.expect_result(seqpar.seqpar_align(
                mode, c.q, c.t, c.p, c.sites, device=run.device,
                loopback=D), f"seqpar_align on {D} ranks")
            c.expect(float(seqpar.seqpar_score(
                mode, c.q, c.t, c.p, c.sites, device=run.device,
                loopback=D)), c.score, f"seqpar_score on {D} ranks")
            checked += 1
        run.log(f"seqpar {mode}: OK ({checked}/{n} cases, "
                f"{'/'.join(map(str, SEQPAR_RANKS))} loopback ranks)")


def route_widths(mode):
    """The target widths (n_pad) at and one quantum past each crossover of
    the table in force that ``mode`` reaches."""
    from aligntools_tpu_torch.engine import select

    caps = {select.score_flat_cap(mode)}
    if mode != "edit":
        caps |= {select.ptr_flat_cap(), 4 * select.blocked_c_blk()}
    return sorted({w for c in caps for w in (c, c + QUANTUM)})


def route_pair(rng, mode, j, width):
    """Pair j of a width group: a target of n_pad ``width`` and a query of
    ROUTE_M's lengths (at most the target in fit, and where it is drawn
    from the target), by turns a random ``gen_seq`` kind and a
    ``utils/synth.related_pair``."""
    from aligntools_tpu_torch.utils.synth import related_pair

    n = int(rng.integers(width - QUANTUM + 1, width + 1))
    m = int(rng.integers(ROUTE_M[0], ROUTE_M[1] + 1))
    if j % 2:
        # a query drawn from the target, with room for its insertions
        q, t = related_pair(max(1, min(m, n - 32)), n,
                            seed=int(rng.integers(1 << 31)))
        return q[: len(t)], t
    kind = KINDS[(j // 2) % len(KINDS)]
    t = gen_seq(rng, kind, n, n)
    m = min(m, n) if mode == "fit" else m
    return gen_seq(rng, kind, m, m), t


def section_routes(run, n_per):
    from aligntools_tpu_torch import batch

    rng = np.random.default_rng(SEEDS["routes"])
    per = max(2, n_per // 40)
    fa = os.path.join(run.tmp, "pair.fa")
    for mode in MODES:
        widths = route_widths(mode)
        g = 0
        for width in widths:
            for jump in ((False, True) if mode == "fit" else (False,)):
                p = (AlignParams() if mode == "overlap"
                     else AlignParams(**PARAM_SETS[g % len(PARAM_SETS)]))
                g += 1
                cases = []
                for j in range(per):
                    q, t = route_pair(rng, mode, j, width)
                    sites = (sorted(int(x) for x in rng.integers(0, len(t), 4))
                             if jump else None)
                    c = Case("routes", mode, len(cases), SEEDS["routes"], q,
                             t, p, sites, pair_command(mode, q, t, p, sites,
                                                       fa))
                    if run.ask(c):
                        cases.append(c)
                prs = [(c.q, c.t) for c in cases]
                sl = [c.sites for c in cases] if jump else None
                what = f"at n_pad {width}"
                for c, s in zip(cases, batch.batch_scores(
                        mode, prs, p, sl, device=run.device)):
                    c.expect(float(s), c.score, f"batch_scores {what}")
                if mode != "edit":
                    for c, r in zip(cases, batch.align_batch(
                            mode, prs, p, sl, traceback=True,
                            device=run.device)):
                        c.expect_result(r, f"align_batch {what}")
        run.log(f"routes {mode}: OK ({g} batches of {per} pairs at n_pad "
                f"{', '.join(map(str, widths))})")


SECTIONS = {
    "main": section_main,
    "native-cli": section_native_cli,
    "rescan": section_rescan,
    "banded-full": section_banded_full,
    "banded-auto": section_banded_auto,
    "seqpar": section_seqpar,
    "routes": section_routes,
}


# --------------------------------------------------------------------------
# The run
# --------------------------------------------------------------------------


def launch_counts() -> dict:
    """Each kernel's launches through its wrapper so far, and the wrapper
    calls that ran plain versions (``plain``)."""
    from aligntools_tpu_torch.engine import device_tb as tb
    from aligntools_tpu_torch.ops import banded, blocked, ptr, scan

    return {**scan.launches, "ptr": ptr.launches, "walk": tb.launches,
            "walk_pause": tb.pause_launches,
            "walk_col_pause": tb.col_pause_launches, **blocked.launches,
            "banded": banded.launches, "banded_cta": banded.launches_cta,
            "ptr64": ptr.launches64,
            "edit64": scan.launches64,
            "plain": (scan.plain_calls + ptr.plain_calls + tb.plain_calls
                      + blocked.plain_calls + banded.plain_calls)}


def run_sections(n_per=120, sections=None, device="cuda", log=None):
    """Run ``sections`` (default all, in SECTIONS' order) on ``device``
    against the native CLI; returns the summary (each section's counters
    and seconds, and each kernel's launches over the run). Raises Mismatch
    on the first result that differs."""
    from aligntools_tpu_torch import native
    from aligntools_tpu_torch.backend import resolve_device

    log = log or (lambda s: print(s, flush=True))
    names = list(SECTIONS) if sections is None else list(sections)
    dev = resolve_device(device)
    oracle = Oracle(native.cli_binary())
    t_run, before = time.perf_counter(), launch_counts()
    with tempfile.TemporaryDirectory(prefix="validate") as tmp:
        run = Run(dev, oracle, tmp, log)
        for name in names:
            run.begin(name)
            t0 = time.perf_counter()
            try:
                SECTIONS[name](run, n_per)
            except Mismatch:
                raise
            except Exception as err:  # a port error: name its case
                if run.current is None:
                    raise
                run.current.fail(f"{type(err).__name__}: {err}")
            if dev.type == "cuda":
                import torch

                torch.cuda.synchronize(dev)
            run.stats["seconds"] = time.perf_counter() - t0
    return {"device": str(dev), "n_per": n_per, "sections": run.sections,
            "seconds": time.perf_counter() - t_run,
            "launches": {k: v - before[k]
                         for k, v in launch_counts().items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python3 -m aligntools_tpu_torch.tools.validate",
        description="Randomized differential campaign of the port against "
                    "the native C++ CLI")
    ap.add_argument("n_per", nargs="?", type=int, default=120,
                    help="cases a mode of the main section (default 120)")
    ap.add_argument("--section", choices=list(SECTIONS),
                    help="run only this section")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ns = ap.parse_args(argv)
    try:
        summary = run_sections(ns.n_per, ns.section and [ns.section],
                               ns.device)
    except (Mismatch, OSError, ValueError, RuntimeError) as err:
        print(f"VALIDATION FAILED: {type(err).__name__}: {err}",
              file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"validate": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

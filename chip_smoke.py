#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (aligntools_tpu_torch) on one GPU.

    python3 chip_smoke.py      # from the repository root; one Hopper card

Phases, one JSON line each:

  device   the card (nvidia-smi name and power limit), torch and CUDA
           versions, and the time to build the kernels from csrc/;
  kernels  each score kernel against its plain PyTorch version on the
           card, bit for bit, for global, local, overlap, edit, fit and
           fit+jump at B=64 ragged pairs of (512, 2048), plus local at the
           bench.py shape 256 x 2048^2 and fit+jump at 64 x (512 x 32768);
           warm median times of both (CUDA events);
  ptr      the pointer kernel against its plain version, bit for bit
           (score, start info and every pointer byte): global, local, fit
           and overlap at rows-per-byte 1 and 2, fit+jump at 1, overlap at
           4, all at 64 ragged pairs of (512, 2048); local at 256 x 2048^2
           (rpb 2, 512 MB of pointers) and fit+jump at 64 x (512 x 32768)
           (rpb 1, 1 GB); then the walk kernel against its plain version
           on each of those pointer tensors (every column and scalar);
  buckets  every bucket the main path below builds, on the card: the
           score kernel against plain for the score runs, and the pointer
           kernel and the walk against plain for the rows runs;
  slice    the port's main path through cli.main in-process, on a
           20,000-pair clustered set (m ~ 300, n ~ 3,000) and on its first
           2,000 pairs with junction sites in the target headers:
             scores  `batch MODE --scores-only`: local on the 20,000, then
                     global, overlap, edit and fit -s on the 2,000; every
                     score kernel launched, no plain version ran;
             rows    `batch MODE` (alignment rows): local on the 20,000,
                     cold and warm, then global, overlap and fit -s on the
                     2,000; the pointer and walk kernels launched, no plain
                     version ran. Each rows TSV's score column equals its
                     scores TSV, and 64 sampled lines of each equal the
                     port's own `--device cpu` run on those pairs (the CPU
                     tests hold that against the JAX package).

    python3 chip_smoke.py --profile TRACE.json

adds a `profile` phase: one more warm rows `batch local` run on the 20,000
pairs under torch.profiler, with the device's busy time per op and its
split between fill, walk, copies and allocation (the zero fills of new
tensors), against the wall, and its Chrome trace written to TRACE.json.

Then the kernels' summary line (each kernel's time, launches on the main
path, bound and plain time), the card's name and power limit as nvidia-smi
prints them, and, last, {"ok": true, "device": {...}}. Any failure exits
nonzero before that line; so does a host without CUDA.
"""

import argparse
import contextlib
import io
import json
import os
import random
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SEED = 7
SAMPLES = 64
CHUNK = 16384  # the CLI's default --chunk-size
TOL = "bit-equal (exact integer f32 / int32; pointers and rows are bytes)"

# kernel -> (its TPU counterpart, source, the variants that run it)
KERNELS = {
    "affine": ("aligntools_tpu/ops/pallas_scan.py:328 _affine_kernel",
               "scan_fill.cu", ("global", "local")),
    "overlap": ("aligntools_tpu/ops/pallas_scan.py:421 _overlap_kernel",
                "scan_fill.cu", ("overlap",)),
    "edit": ("aligntools_tpu/ops/pallas_scan.py:469 _edit_kernel",
             "scan_fill.cu", ("edit",)),
    "fit": ("aligntools_tpu/ops/pallas_scan.py:513 _fit_kernel",
            "scan_fill.cu", ("fit", "fit+jump")),
    "ptr": ("aligntools_tpu/ops/pallas_ptr.py:85 _ptr_kernel",
            "ptr_fill.cu", ()),
    "walk": ("aligntools_tpu/engine/device_tb.py:56 _walk_affine, "
             ":166 _walk_overlap", "walk.cu", ()),
}
# (B, m_pad, n_pad, ragged lengths, score variants)
SHAPES = [
    (64, 512, 2048, True, ("global", "local", "overlap", "edit", "fit",
                           "fit+jump")),
    (256, 2048, 2048, False, ("local",)),
    (64, 512, 32768, True, ("fit+jump",)),
]
# (B, m_pad, n_pad, ragged lengths, (mode, jump, rows per byte) cases)
PTR_SHAPES = [
    (64, 512, 2048, True, (
        ("global", False, 1), ("global", False, 2), ("local", False, 1),
        ("local", False, 2), ("fit", False, 1), ("fit", False, 2),
        ("fit", True, 1), ("overlap", False, 1), ("overlap", False, 2),
        ("overlap", False, 4))),
    (256, 2048, 2048, False, (("local", False, 2),)),
    (64, 512, 32768, True, (("fit", True, 1),)),
]

# The least time the card could take for the same work: the
# larger of the operations over 33.5 T op/s (67 TFLOP/s of f32 counts an
# FMA as two; each add, max/min and compare is one op) and the bytes
# moved (each input read once, each output written once) over 3.35 TB/s.
PEAK_OPS = 33.5e12
PEAK_BYTES = 3.35e12
# ops per true DP cell, counted from the recurrences the kernels compute:
#   global  sub compare 1, M = diag + sub 1, L = max(L+e, M+o) 3,
#           U = max(M+o, U+e) 3, best = max(L, M, U) 2            -> 10
#   local   global + max(M, 0) + the running max of M               -> 12
#   overlap sub 1, diag + sub 1, M + o 1, max 1, left chain 2, the
#           bottom-row max 1                                        -> 7
#   edit    the same chain in min-plus int32                        -> 7
#   fit     global's 10; + jump: entry add 1, chain max 1, best max 1
# the pointer fill adds to its mode's count: the earliest-argument argmax
# (2 compares, 3 with the jump, 4 with local's HOME), the unset compare 1
# and the pL / pU (/ pJ 2) bit compares; the walk counts ~20 int32 ops a
# step (activity, clamps, decode, next state, moves).
SCORE_OPS = {"global": 10, "local": 12, "overlap": 7, "edit": 7, "fit": 10,
             "fit+jump": 13}
PTR_EXTRA_OPS = {"global": 5, "local": 7, "overlap": 3, "fit": 5,
                 "fit+jump": 8}
WALK_OPS_PER_STEP = 20
WALK_BYTES_PER_STEP = 11  # 1 pointer byte, 2 int32 chars, 2 column bytes


def bound(ops, nbytes):
    t_ops, t_bytes = ops / PEAK_OPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def emit(obj):
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def nvidia_smi_line():
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return r.stdout.strip().splitlines()[0]


def kernel_inputs(B, m_pad, n_pad, ragged, seed, device):
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
    if ragged:
        ms = rng.integers(m_pad // 2, m_pad + 1, (B, 1))
        ns = np.maximum(rng.integers(n_pad // 2, n_pad + 1, (B, 1)), ms)
    else:
        ms, ns = np.full((B, 1), m_pad), np.full((B, 1), n_pad)
    qs = rng.choice(alpha, (B, m_pad))
    ts = rng.choice(alpha, (B, n_pad))
    qs[np.arange(m_pad)[None, :] >= ms] = -1
    ts[np.arange(n_pad)[None, :] >= ns] = -2
    allow = (rng.random((B, n_pad)) > 0.05).astype(np.float32)
    pm = np.array([[1, -2, -5, -1, -10, 0, 0, 0]], np.float32)
    from aligntools_tpu_torch.convert import kernel_inputs_from_numpy

    args = kernel_inputs_from_numpy(qs, ts, allow, ns.astype(np.int32),
                                    ms.astype(np.int32), pm, device)
    return args, int((ms * ns).sum())


def input_bytes(args, with_allow):
    qs, ts, allow, ns, ms, pm = args
    xs = [qs, ts, ns, ms, pm] + ([allow] if with_allow else [])
    return sum(x.numel() * x.element_size() for x in xs)


def run_variant(scan, variant, m_pad, n_pad, args, plain):
    qs, ts, allow, ns, ms, pm = args
    if variant.startswith("fit"):
        fn = scan.fit_scores_plain if plain else scan.fit_scores
        return fn(variant == "fit+jump", m_pad, n_pad, qs, ts, allow, ns, ms,
                  pm)
    fn = scan.scores_plain if plain else scan.scores
    return fn(variant, m_pad, n_pad, qs, ts, ns, ms, pm)


def timed_ms(torch, fn):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end)


def turns(torch, kernel, plain, rounds=2):
    """Warm medians (kernel ms, plain ms), timed in turns plain, kernel,
    kernel, plain."""
    t_k, t_p = [], []
    for _ in range(rounds):
        t_p.append(timed_ms(torch, plain))
        t_k += [timed_ms(torch, kernel), timed_ms(torch, kernel)]
        t_p.append(timed_ms(torch, plain))
    return statistics.median(t_k), statistics.median(t_p)


def max_err(torch, got, want):
    """Largest |got - want| over values both hold finite; inf where they
    disagree on which are finite."""
    g, w = got.double(), want.double()
    fin = torch.isfinite(w)
    if not torch.equal(fin, torch.isfinite(g)):
        return float("inf")
    diff = (g - w)[fin].abs()
    return float(diff.max()) if diff.numel() else 0.0


def compare(torch, scan, variant, m_pad, n_pad, args):
    """Kernel and plain version on the same inputs: (bit_equal,
    max_abs_err)."""
    k_out = run_variant(scan, variant, m_pad, n_pad, args, False)
    torch.cuda.synchronize()
    p_out = run_variant(scan, variant, m_pad, n_pad, args, True)
    torch.cuda.synchronize()
    return bool(torch.equal(k_out, p_out)), max_err(torch, k_out, p_out)


def phase_kernels(torch, scan):
    results = []
    for B, m_pad, n_pad, ragged, variants in SHAPES:
        args, cells = kernel_inputs(B, m_pad, n_pad, ragged, SEED, "cuda")
        for variant in variants:
            equal, err = compare(torch, scan, variant, m_pad, n_pad, args)
            ms_k, ms_p = turns(
                torch,
                lambda: run_variant(scan, variant, m_pad, n_pad, args, False),
                lambda: run_variant(scan, variant, m_pad, n_pad, args, True))
            b_ms, b_by = bound(
                SCORE_OPS[variant] * cells,
                input_bytes(args, variant == "fit+jump") + 4 * B)
            row = {
                "phase": "kernels", "variant": variant,
                "shape": f"{B}x{m_pad}x{n_pad}", "ragged": ragged,
                "bit_equal": equal, "max_abs_err": err, "tolerance": TOL,
                "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                "bound_by": b_by, "true_cells": cells,
                "gcups": cells / ms_k / 1e6, "plain_gcups": cells / ms_p / 1e6,
            }
            emit(row)
            check(equal and err == 0.0,
                  f"{variant} at {B}x({m_pad}x{n_pad}): kernel != plain")
            results.append(row)
    return results


def ptr_compare(torch, ptr, tb, mode, jump, rpb, m_pad, n_pad, args):
    """Pointer kernel vs plain, then walk kernel vs plain on the kernel's
    pointers: (fill_equal, fill_err, walk_equal, walk_err, k_out, walk
    outputs, starts)."""
    qs, ts, allow, ns, ms, pm = args
    k_out = ptr.ptr_fill(mode, jump, m_pad, n_pad, qs, ts, allow, ns, ms, pm,
                         rpb)
    torch.cuda.synchronize()
    p_out = ptr.ptr_fill_plain(mode, jump, m_pad, n_pad, qs, ts, allow, ns,
                               ms, pm, rpb)
    torch.cuda.synchronize()
    f_equal = all(torch.equal(k, p) for k, p in zip(k_out, p_out))
    f_err = max([max_err(torch, k, p) for k, p in zip(k_out[:3], p_out[:3])]
                + [0.0 if torch.equal(k_out[3], p_out[3]) else float("inf")])
    del p_out
    starts = tb.walk_starts(mode, *k_out[:3], ms, ns)
    w_k = tb.walk(mode, rpb, k_out[3], qs, ts, starts)
    torch.cuda.synchronize()
    w_p = tb.walk_plain(mode, rpb, k_out[3], qs, ts, starts)
    torch.cuda.synchronize()
    w_equal = all(torch.equal(k, p) for k, p in zip(w_k, w_p))
    w_err = max([max_err(torch, w_k[2], w_p[2])]
                + [0.0 if torch.equal(k, p) else float("inf")
                   for k, p in zip(w_k[:2], w_p[:2])])
    return f_equal, f_err, w_equal, w_err, k_out, w_k, starts


def phase_ptr(torch, ptr, tb):
    fills, walks = [], []
    for B, m_pad, n_pad, ragged, cases in PTR_SHAPES:
        args, cells = kernel_inputs(B, m_pad, n_pad, ragged, SEED, "cuda")
        qs, ts, allow, ns, ms, pm = args
        for mode, jump, rpb in cases:
            variant = mode + ("+jump" if jump else "")
            shape = f"{B}x{m_pad}x{n_pad}"
            f_eq, f_err, w_eq, w_err, k_out, w_k, starts = ptr_compare(
                torch, ptr, tb, mode, jump, rpb, m_pad, n_pad, args)
            fill = (lambda: ptr.ptr_fill(mode, jump, m_pad, n_pad, qs, ts,
                                         allow, ns, ms, pm, rpb))
            fill_plain = (lambda: ptr.ptr_fill_plain(
                mode, jump, m_pad, n_pad, qs, ts, allow, ns, ms, pm, rpb))
            ms_k, ms_p = turns(torch, fill, fill_plain, rounds=1)
            ptr_bytes = k_out[3].numel()
            b_ms, b_by = bound(
                (SCORE_OPS[variant] + PTR_EXTRA_OPS[variant]) * cells,
                input_bytes(args, jump) + ptr_bytes + 12 * B)
            row = {"phase": "ptr", "variant": f"{variant}/rpb{rpb}",
                   "shape": shape, "bit_equal": f_eq, "max_abs_err": f_err,
                   "tolerance": TOL, "ms": ms_k, "plain_ms": ms_p,
                   "bound_ms": b_ms, "bound_by": b_by, "true_cells": cells,
                   "ptr_bytes": ptr_bytes, "gcups": cells / ms_k / 1e6}
            emit(row)
            check(f_eq and f_err == 0.0,
                  f"pointer fill {variant} rpb {rpb} at {shape}: kernel != "
                  f"plain")
            fills.append(row)
            ptrs = k_out[3]
            steps = int(w_k[2][0].sum())
            ms_k, ms_p = turns(
                torch, lambda: tb.walk(mode, rpb, ptrs, qs, ts, starts),
                lambda: tb.walk_plain(mode, rpb, ptrs, qs, ts, starts),
                rounds=1)
            b_ms, b_by = bound(WALK_OPS_PER_STEP * steps,
                               WALK_BYTES_PER_STEP * steps + 28 * B)
            row = {"phase": "walk", "variant": f"{variant}/rpb{rpb}",
                   "shape": shape, "bit_equal": w_eq, "max_abs_err": w_err,
                   "tolerance": TOL, "ms": ms_k, "plain_ms": ms_p,
                   "bound_ms": b_ms, "bound_by": b_by, "steps": steps,
                   "longest_walk": int(w_k[2][0].max())}
            emit(row)
            check(w_eq and w_err == 0.0,
                  f"walk {variant} rpb {rpb} at {shape}: kernel != plain")
            walks.append(row)
            del k_out, w_k, ptrs
        del args, qs, ts, allow, ns, ms, pm
        torch.cuda.empty_cache()
    return fills, walks


def write_fasta(path, pairs, sites=None, names=None):
    names = range(len(pairs)) if names is None else names
    with open(path, "w") as f:
        for k, (q, t), s in zip(names, pairs, sites or [None] * len(pairs)):
            head = f" {'|'.join(map(str, s))}" if s is not None else ""
            f.write(f">q{k}\n{q.decode()}\n>t{k}{head}\n{t.decode()}\n")


def run_cli(cli, argv):
    """cli.main in-process; returns (wall seconds, its stderr report)."""
    err = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    check(rc == 0, f"{' '.join(argv)} exited {rc}: {err.getvalue()}")
    return wall, err.getvalue().strip()


def read_lines(path):
    with open(path) as f:
        return f.read().splitlines()


def check_rows_tsv(cli, work, rows_tsv, scores_tsv, pairs, mode, sites):
    """The rows TSV's names and score column equal the scores TSV's; 64
    sampled lines equal the port's --device cpu run on those pairs."""
    rows, scores = read_lines(rows_tsv), read_lines(scores_tsv)
    check(len(rows) == len(scores) == len(pairs),
          f"{mode}: {len(rows)} rows lines, {len(scores)} score lines for "
          f"{len(pairs)} pairs")
    for k, (r, s) in enumerate(zip(rows, scores)):
        check(r.split("\t")[:3] == s.split("\t"),
              f"{mode}: line {k}: rows and scores runs disagree")
    picks = sorted(random.Random(SEED).sample(range(len(pairs)), SAMPLES))
    sample_fa = os.path.join(work, f"{mode}-sample.fa")
    write_fasta(sample_fa, [pairs[k] for k in picks],
                [sites[k] for k in picks] if sites else None, names=picks)
    cpu_tsv = os.path.join(work, f"{mode}-sample.cpu.tsv")
    run_cli(cli, ["batch", mode, sample_fa, *(["-s"] if sites else []),
                  "--device", "cpu", "--out", cpu_tsv])
    for k, line in zip(picks, read_lines(cpu_tsv)):
        check(rows[k] == line, f"{mode}: pair {k}: card and CPU rows differ")
    return len(picks)


def main_path_buckets(pairs, sites):
    """The buckets the pipeline builds: one global partition, sliced per
    chunk."""
    from aligntools_tpu_torch import batch

    keys = batch._bucket_keys(pairs, 64, 128)
    out = []
    for lo in range(0, len(pairs), CHUNK):
        out += batch._bucketize(pairs[lo : lo + CHUNK],
                                sites[lo : lo + CHUNK] if sites else None,
                                keys[lo : lo + CHUNK]).values()
    return out


def phase_buckets(torch, scan, ptr, tb, variant, pairs, sites, params,
                  rows):
    """Kernel vs plain on every bucket the main path builds for ``pairs``,
    at the bucket's own B: the score kernel, or (``rows``) the pointer
    kernel and the walk."""
    from aligntools_tpu_torch import batch, layout
    from aligntools_tpu_torch.convert import params_matrix

    pm = params_matrix(params, "cuda")
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    shapes, worst = [], 0.0
    for b in main_path_buckets(pairs, sites):
        qs, ts, allow, ns, ms = batch._bucket_tensors(b, torch.device("cuda"))
        shape = f"{len(b.idx)}x{b.m_pad}x{b.n_pad}"
        if rows:
            rpb = layout.rows_per_byte(mode, jump, b.m_pad)
            f_eq, f_err, w_eq, w_err, *_ = ptr_compare(
                torch, ptr, tb, mode, jump, rpb, b.m_pad, b.n_pad,
                (qs, ts, allow, ns, ms, pm))
            equal, err = f_eq and w_eq, max(f_err, w_err)
            shape += f"/rpb{rpb}"
        else:
            equal, err = compare(torch, scan, variant, b.m_pad, b.n_pad,
                                 (qs, ts, allow, ns, ms, pm))
        check(equal and err == 0.0,
              f"{variant} on main-path bucket {shape}: kernel != plain"
              + (" (pointer fill or walk)" if rows else ""))
        shapes.append(shape)
        worst = max(worst, err)
        del qs, ts, allow, ns, ms
    torch.cuda.empty_cache()
    row = {"phase": "buckets", "path": "rows" if rows else "scores",
           "variant": variant, "buckets": len(shapes), "shapes": shapes,
           "bit_equal": True, "max_abs_err": worst, "tolerance": TOL}
    emit(row)
    return row


def counts(scan, ptr, tb):
    return ({**scan.launches, "ptr": ptr.launches, "walk": tb.launches},
            {"scan": scan.plain_calls, "ptr": ptr.plain_calls,
             "walk": tb.plain_calls})


def reset_counts(scan, ptr, tb):
    scan.reset_counts()
    ptr.reset_counts()
    tb.reset_counts()


def phase_slice(torch, scan, ptr, tb, work, trace_path):
    import numpy as np

    from aligntools_tpu_torch import cli
    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.utils.synth import clustered_pairs

    params = AlignParams()
    pairs = clustered_pairs(20000, seed=SEED)
    cells = sum(len(q) * len(t) for q, t in pairs)
    big = os.path.join(work, "clustered20k.fa")
    write_fasta(big, pairs)
    small = pairs[:2000]
    check(all(len(q) <= len(t) for q, t in small), "fit needs m <= n")
    rng = np.random.default_rng(SEED)
    sites = [sorted(int(x) for x in rng.integers(0, len(t), 3))
             for _, t in small]
    small_fa = os.path.join(work, "sites2k.fa")
    write_fasta(small_fa, small, sites)
    small_cells = sum(len(q) * len(t) for q, t in small)
    runs_in = {"local": (big, pairs, cells, None)}
    for mode in ("global", "overlap", "edit", "fit"):
        runs_in[mode] = (small_fa, small, small_cells,
                         sites if mode == "fit" else None)

    checked_buckets = [phase_buckets(torch, scan, ptr, tb, "local", pairs,
                                     None, params, False)]
    for variant in ("global", "overlap", "edit", "fit+jump"):
        checked_buckets.append(phase_buckets(
            torch, scan, ptr, tb, variant, small,
            sites if variant == "fit+jump" else None, params, False))
    checked_buckets.append(phase_buckets(torch, scan, ptr, tb, "local",
                                         pairs, None, params, True))
    for variant in ("global", "overlap", "fit+jump"):
        checked_buckets.append(phase_buckets(
            torch, scan, ptr, tb, variant, small,
            sites if variant == "fit+jump" else None, params, True))

    def run(mode, label, rows):
        fasta, ps, n_cells, s = runs_in[mode]
        tsv = os.path.join(work, f"{mode}-{'rows' if rows else 'scores'}-"
                                 f"{label}.tsv")
        argv = ["batch", mode, fasta, *(["-s"] if s else []),
                *([] if rows else ["--scores-only"]), "--out", tsv]
        wall, report = run_cli(cli, argv)
        emit({"phase": "slice", "path": "rows" if rows else "scores",
              "mode": mode + (" -s" if s else ""), "run": label,
              "pairs": len(ps), "seconds": wall,
              "pairs_per_s": len(ps) / wall,
              "true_gcups": n_cells / wall / 1e9, "counters": report})
        return tsv

    # the score path of the main path: its launches start here
    reset_counts(scan, ptr, tb)
    scores_tsv = {mode: run(mode, "warm", False) for mode in runs_in}
    torch.cuda.synchronize()
    score_launches, plain = counts(scan, ptr, tb)
    for name in ("affine", "overlap", "edit", "fit"):
        check(score_launches[name] > 0,
              f"kernel {name} never launched on the score path")
    check(not any(plain.values()), f"plain versions ran on the score path: "
          f"{plain}")

    # the rows path: its launches start here
    reset_counts(scan, ptr, tb)
    cold = run("local", "cold", True)
    rows_tsv = {"local": run("local", "warm", True)}
    for mode in ("global", "overlap", "fit"):
        rows_tsv[mode] = run(mode, "cold", True)
    torch.cuda.synchronize()
    rows_launches, plain = counts(scan, ptr, tb)
    emit({"phase": "slice", "score_path_launches": score_launches,
          "rows_path_launches": rows_launches, "plain_calls": plain})
    for name in ("ptr", "walk"):
        check(rows_launches[name] > 0,
              f"kernel {name} never launched on the rows path")
    check(not any(plain.values()), f"plain versions ran on the rows path: "
          f"{plain}")

    with open(cold, "rb") as a, open(rows_tsv["local"], "rb") as b:
        check(a.read() == b.read(), "local: cold and warm rows TSVs differ")
    checked = {}
    for mode, tsv in rows_tsv.items():
        _, ps, _, s = runs_in[mode]
        checked[mode] = check_rows_tsv(cli, work, tsv, scores_tsv[mode], ps,
                                       mode, s)
    emit({"phase": "slice", "rows_equal_scores": sorted(rows_tsv),
          "cpu_checked": checked})
    if trace_path:
        phase_profile(torch, cli, big, work, trace_path)
    launches = {**{k: score_launches[k] for k in scan.launches},
                "ptr": rows_launches["ptr"], "walk": rows_launches["walk"]}
    return launches, checked_buckets


PROFILE_GROUPS = (("fill", ("ptr_affine", "ptr_overlap")),
                  ("walk", ("walk_kernel",)),
                  ("copies", ("Memcpy", "memcpy")),
                  ("allocation", ("Memset", "memset", "FillFunctor")))


def phase_profile(torch, cli, fasta, work, trace_path):
    """One more warm rows `batch local` run under torch.profiler: device
    time per op (CUDA kernels and copies) against the run's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    tsv = os.path.join(work, "local-profiled.tsv")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, report = run_cli(cli, ["batch", "local", fasta, "--out", tsv])
        torch.cuda.synchronize()
    ops = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        ms = ev.device_time_total / 1000
        if ms > 0:
            ops.append({"op": ev.key[:80], "calls": ev.count, "ms": ms})
    ops.sort(key=lambda o: -o["ms"])
    busy = sum(o["ms"] for o in ops)
    split = {name: 0.0 for name, _ in PROFILE_GROUPS}
    split["other"] = 0.0
    for o in ops:
        group = next((name for name, keys in PROFILE_GROUPS
                      if any(k in o["op"] for k in keys)), "other")
        split[group] += o["ms"]
    prof.export_chrome_trace(trace_path)
    emit({"phase": "profile", "mode": "local", "path": "rows",
          "wall_s": wall, "device_busy_ms": busy,
          "busy_share": busy / 1000 / wall, "split_ms": split,
          "counters": report, "device_ops": ops[:12], "trace": trace_path})
    check(busy > 0, "torch.profiler recorded no device time")


def summary(rows, ptr_rows, walk_rows, bucket_rows, launches):
    out = []
    for name, (replaces, src, variants) in KERNELS.items():
        if name == "ptr":
            timed, mine = ptr_rows, ptr_rows + [
                r for r in bucket_rows if r["path"] == "rows"]
        elif name == "walk":
            timed, mine = walk_rows, walk_rows
        else:
            timed = [r for r in rows if r["variant"] in variants]
            mine = timed + [r for r in bucket_rows if r["path"] == "scores"
                            and r["variant"] in variants]
        # the representative timing: the rows path's local at rpb 2 on the
        # bench.py shape for the pointer fill and the walk, else the first
        # shape's last variant
        rep = next((r for r in timed if r["variant"] == "local/rpb2"
                    and r["shape"] == "256x2048x2048"),
                   [r for r in timed if r["shape"] == timed[0]["shape"]][-1])
        out.append({
            "name": name, "route": "cuda",
            "source": f"aligntools_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "bound_ms": rep["bound_ms"], "bound_by": rep["bound_by"],
            "library_ms": None,
            "variant": rep["variant"], "shape": rep["shape"],
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch / "
                                             "CUDA port on one GPU")
    ap.add_argument("--profile", metavar="TRACE.json", default=None,
                    help="also profile one warm 20,000-pair rows local run "
                         "and write its Chrome trace here")
    opts = ap.parse_args(argv)
    try:
        import torch
    except ImportError as err:
        print(f"chip_smoke: torch is not importable: {err}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from aligntools_tpu_torch import native
    from aligntools_tpu_torch.backend import resolve_device
    from aligntools_tpu_torch.engine import device_tb as tb
    from aligntools_tpu_torch.ops import _build, ptr, scan

    smi = nvidia_smi_line()
    resolve_device("cuda")  # raises unless the card is sm_90
    t0 = time.perf_counter()
    _build.load()
    t1 = time.perf_counter()
    parser = native.get_lib() is not None
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "library": _build.library_path(),
          "build_s": _build.build_seconds, "load_s": t1 - t0,
          "native_parser": parser, "parser_build_s": time.perf_counter() - t1})

    rows = phase_kernels(torch, scan)
    ptr_rows, walk_rows = phase_ptr(torch, ptr, tb)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        launches, bucket_rows = phase_slice(
            torch, scan, ptr, tb, work,
            opts.profile and os.path.abspath(opts.profile))

    emit({"kernels": summary(rows, ptr_rows, walk_rows, bucket_rows,
                             launches)})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

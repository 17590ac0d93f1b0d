#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (aligntools_tpu_torch) on one GPU.

    python3 chip_smoke.py      # from the repository root; one Hopper card

Phases, one JSON line each:

  device   the card (nvidia-smi name and power limit), torch and CUDA
           versions, and the time to build the kernels from csrc/;
  kernels  each CUDA kernel against its plain PyTorch version on the card,
           bit for bit, for global, local, overlap, edit, fit and fit+jump
           at B=64 ragged pairs of (512, 2048), plus local at the bench.py
           shape 256 x 2048^2 and fit+jump at 64 x (512 x 32768); warm
           median times of both (CUDA events);
  buckets  every (m_pad, n_pad) bucket that the main path below builds,
           filled on the card by each kernel and by its plain version on
           the same inputs, bit for bit;
  slice    the port's main path, `aligntools-torch batch MODE FASTA
           --scores-only` through cli.main in-process: local on a
           20,000-pair clustered set (m ~ 300, n ~ 3,000; run twice, cold
           and warm), then global, overlap, edit and fit -s on 2,000 pairs
           with junction sites in the target headers. 64 sampled pairs of
           each run are held against the numpy spec engine; every kernel's
           launch count over these runs must be > 0 and the plain
           versions' call count 0.

    python3 chip_smoke.py --profile TRACE.json

adds a `profile` phase: one more warm `batch local` run on the 20,000
pairs under torch.profiler, with the device's busy time per op against the
wall, and its Chrome trace written to TRACE.json.

Then the kernels' summary line, the card's name and power limit as
nvidia-smi prints them, and, last, {"ok": true, "device": {...}}. Any
failure exits nonzero before that line; so does a host without CUDA.
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

# kernel -> (its TPU counterpart, the variants that run it)
KERNELS = {
    "affine": ("aligntools_tpu/ops/pallas_scan.py:328 _affine_kernel",
               ("global", "local")),
    "overlap": ("aligntools_tpu/ops/pallas_scan.py:421 _overlap_kernel",
                ("overlap",)),
    "edit": ("aligntools_tpu/ops/pallas_scan.py:469 _edit_kernel",
             ("edit",)),
    "fit": ("aligntools_tpu/ops/pallas_scan.py:513 _fit_kernel",
            ("fit", "fit+jump")),
}
# (B, m_pad, n_pad, ragged lengths, variants)
SHAPES = [
    (64, 512, 2048, True, ("global", "local", "overlap", "edit", "fit",
                           "fit+jump")),
    (256, 2048, 2048, False, ("local",)),
    (64, 512, 32768, True, ("fit+jump",)),
]


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


def compare(torch, scan, variant, m_pad, n_pad, args):
    """Kernel and plain version on the same inputs: (bit_equal, max_abs_err
    over finite values; inf where the two disagree on which are finite)."""
    k_out = run_variant(scan, variant, m_pad, n_pad, args, False)
    torch.cuda.synchronize()
    p_out = run_variant(scan, variant, m_pad, n_pad, args, True)
    torch.cuda.synchronize()
    equal = bool(torch.equal(k_out, p_out))
    fin = torch.isfinite(p_out.double())
    if not torch.equal(fin, torch.isfinite(k_out.double())):
        return False, float("inf")
    diff = (k_out.double() - p_out.double())[fin].abs()
    return equal, float(diff.max()) if diff.numel() else 0.0


def phase_kernels(torch, scan):
    results = []
    for B, m_pad, n_pad, ragged, variants in SHAPES:
        args, cells = kernel_inputs(B, m_pad, n_pad, ragged, SEED, "cuda")
        for variant in variants:
            equal, err = compare(torch, scan, variant, m_pad, n_pad, args)
            # turns: plain, kernel, kernel, plain (twice)
            t_k, t_p = [], []
            for _ in range(2):
                t_p.append(timed_ms(torch, lambda: run_variant(
                    scan, variant, m_pad, n_pad, args, True)))
                for _ in range(2):
                    t_k.append(timed_ms(torch, lambda: run_variant(
                        scan, variant, m_pad, n_pad, args, False)))
                t_p.append(timed_ms(torch, lambda: run_variant(
                    scan, variant, m_pad, n_pad, args, True)))
            ms_k, ms_p = statistics.median(t_k), statistics.median(t_p)
            row = {
                "phase": "kernels", "variant": variant,
                "shape": f"{B}x{m_pad}x{n_pad}", "ragged": ragged,
                "bit_equal": equal, "max_abs_err": err,
                "tolerance": "bit-equal (exact integer f32 / int32)",
                "ms": ms_k, "plain_ms": ms_p, "true_cells": cells,
                "gcups": cells / ms_k / 1e6, "plain_gcups": cells / ms_p / 1e6,
            }
            emit(row)
            check(equal and err == 0.0,
                  f"{variant} at {B}x({m_pad}x{n_pad}): kernel != plain")
            results.append(row)
    return results


def write_fasta(path, pairs, sites=None):
    with open(path, "w") as f:
        for k, (q, t) in enumerate(pairs):
            head = f" {'|'.join(map(str, sites[k]))}" if sites else ""
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


def check_tsv(path, pairs, mode, spec, params, sites=None):
    with open(path) as f:
        lines = f.read().splitlines()
    check(len(lines) == len(pairs), f"{mode}: {len(lines)} TSV lines for "
          f"{len(pairs)} pairs")
    rng = random.Random(SEED)
    picks = rng.sample(range(len(pairs)), SAMPLES)
    for k in picks:
        name1, name2, score = lines[k].split("\t")
        check((name1, name2) == (f"q{k}", f"t{k}"), f"{mode}: line {k} names")
        q, t = pairs[k]
        if mode == "edit":
            want = spec.spec_edit(q, t, params)
            got = int(score)
        elif mode == "fit":
            want = spec.spec_fit(q, t, params, sites[k]).score
            got = float(score)
        else:
            want = getattr(spec, f"spec_{mode}")(q, t, params).score
            got = float(score)
        check(got == want, f"{mode}: pair {k} scored {got}, spec says {want}")
    return len(picks)


def phase_buckets(torch, scan, variant, pairs, sites, params):
    """Kernel vs plain on every bucket the main path builds for ``pairs``
    (the pipeline's one global partition), at the bucket's own B."""
    from aligntools_tpu_torch import batch
    from aligntools_tpu_torch.convert import params_matrix

    pm = params_matrix(params, "cuda")
    buckets = batch._bucketize(pairs, sites,
                               batch._bucket_keys(pairs, 64, 128))
    shapes, worst = [], 0.0
    for b in buckets.values():
        qs, ts, allow, ns, ms = batch._bucket_tensors(b, torch.device("cuda"))
        args = (qs, ts, allow, ns, ms, pm)
        equal, err = compare(torch, scan, variant, b.m_pad, b.n_pad, args)
        shape = f"{len(b.idx)}x{b.m_pad}x{b.n_pad}"
        check(equal and err == 0.0,
              f"{variant} on main-path bucket {shape}: kernel != plain")
        shapes.append(shape)
        worst = max(worst, err)
    row = {"phase": "buckets", "variant": variant, "buckets": len(shapes),
           "shapes": shapes, "bit_equal": True, "max_abs_err": worst,
           "tolerance": "bit-equal (exact integer f32 / int32)"}
    emit(row)
    return row


def phase_slice(torch, scan, work, trace_path):
    import numpy as np

    from aligntools_tpu.params import AlignParams
    from aligntools_tpu.spec import engine as spec
    from aligntools_tpu.utils.synth import clustered_pairs
    from aligntools_tpu_torch import cli

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

    checked_buckets = [phase_buckets(torch, scan, "local", pairs, None,
                                     params)]
    for variant in ("global", "overlap", "edit", "fit+jump"):
        checked_buckets.append(phase_buckets(
            torch, scan, variant, small,
            sites if variant == "fit+jump" else None, params))

    scan.reset_counts()  # the main path's launches start here
    runs = []
    outs = []
    for label in ("cold", "warm"):
        tsv = os.path.join(work, f"local-{label}.tsv")
        wall, report = run_cli(cli, ["batch", "local", big, "--scores-only",
                                     "--out", tsv])
        outs.append(tsv)
        runs.append({"mode": "local", "run": label, "pairs": len(pairs),
                     "seconds": wall, "pairs_per_s": len(pairs) / wall,
                     "true_gcups": cells / wall / 1e9, "counters": report})
    with open(outs[0], "rb") as a, open(outs[1], "rb") as b:
        check(a.read() == b.read(), "local: cold and warm TSVs differ")
    checked = {"local": check_tsv(outs[1], pairs, "local", spec, params)}
    for mode in ("global", "overlap", "edit", "fit"):
        tsv = os.path.join(work, f"{mode}.tsv")
        extra = ["-s"] if mode == "fit" else []
        wall, report = run_cli(cli, ["batch", mode, small_fa, *extra,
                                     "--scores-only", "--out", tsv])
        runs.append({"mode": mode + (" -s" if extra else ""), "run": "cold",
                     "pairs": len(small), "seconds": wall,
                     "pairs_per_s": len(small) / wall,
                     "true_gcups": small_cells / wall / 1e9,
                     "counters": report})
        checked[mode] = check_tsv(tsv, small, mode, spec, params,
                                  sites if mode == "fit" else None)
    torch.cuda.synchronize()
    launches, plain_calls = dict(scan.launches), scan.plain_calls
    for run in runs:
        emit({"phase": "slice", **run})
    emit({"phase": "slice", "spec_checked": checked, "launches": launches,
          "plain_calls": plain_calls})
    for name, n in launches.items():
        check(n > 0, f"kernel {name} never launched on the main path")
    check(plain_calls == 0, f"plain versions ran {plain_calls} times on the "
          f"main path")
    if trace_path:
        phase_profile(torch, cli, big, work, trace_path)
    return launches, checked_buckets


def phase_profile(torch, cli, fasta, work, trace_path):
    """One more warm `batch local` run under torch.profiler: device time
    per op (CUDA kernels and copies) against the run's wall clock."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    tsv = os.path.join(work, "local-profiled.tsv")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, report = run_cli(cli, ["batch", "local", fasta, "--scores-only",
                                     "--out", tsv])
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
    prof.export_chrome_trace(trace_path)
    emit({"phase": "profile", "mode": "local", "wall_s": wall,
          "device_busy_ms": busy, "busy_share": busy / 1000 / wall,
          "counters": report, "device_ops": ops[:12], "trace": trace_path})
    check(busy > 0, "torch.profiler recorded no device time")


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch / "
                                             "CUDA port on one GPU")
    ap.add_argument("--profile", metavar="TRACE.json", default=None,
                    help="also profile one warm 20,000-pair local run and "
                         "write its Chrome trace here")
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
    from aligntools_tpu_torch.backend import resolve_device
    from aligntools_tpu_torch.ops import _build, scan

    smi = nvidia_smi_line()
    resolve_device("cuda")  # raises unless the card is sm_90
    t0 = time.perf_counter()
    _build.load()
    emit({"phase": "device", "nvidia_smi": smi,
          "kind": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "library": _build.library_path(),
          "build_s": _build.build_seconds,
          "load_s": time.perf_counter() - t0})

    rows = phase_kernels(torch, scan)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        launches, bucket_rows = phase_slice(
            torch, scan, work,
            opts.profile and os.path.abspath(opts.profile))

    summary = []
    for name, (replaces, variants) in KERNELS.items():
        mine = [r for r in rows + bucket_rows if r["variant"] in variants]
        timed = [r for r in rows if r["variant"] in variants]
        rep = [r for r in timed if r["shape"] == timed[0]["shape"]][-1]
        summary.append({
            "name": name, "route": "cuda",
            "source": "aligntools_tpu_torch/csrc/scan_fill.cu",
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": rep["ms"], "plain_ms": rep["plain_ms"],
            "variant": rep["variant"], "shape": rep["shape"],
        })
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

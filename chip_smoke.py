#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (aligntools_tpu_torch) on one GPU.

    python3 chip_smoke.py      # from the repository root; one Hopper card

Every phase routes by engine/autotune.DEFAULTS: the run (and every CLI
process it starts) reads its table from an empty ALIGNTOOLS_TORCH_CACHE
of its own, so a table `calibrate` left on the machine changes nothing the
script checks or names.

Phases, one JSON line each:

  device   the card (nvidia-smi name and power limit), torch and CUDA
           versions, and the time to build the kernels from csrc/;
  probe    the ceiling probe (aligntools_tpu_torch.tools.vpu_probe, the
           counterpart of tools/vpu_probe.py): the chain loops of each
           instantiation of csrc/vpu_probe.cu in its SASS (cuobjdump),
           failing one with fewer than a link's three ops a max; its nine
           variants against plain, bit for bit, at the JAX shapes and an
           odd element count, chain 64; then, its launches counted from 0,
           vmem_ceiling(), vpu_roofline() and roofline_ops_per_sec() for
           float32 and int32 at the JAX defaults: T op/s, ops a clock an SM
           at the SM clock nvidia-smi reads under each one's launch, and the
           fraction of PEAK_OPS, failing a reading above 105% of the issue
           ceiling (a folded chain); fill_scaling (local fill GCUPS at the
           JAX tile-sweep cases). The measured float32, int32 and float64
           rates give every later timing row its `probe_ms` (counted ops
           over the rate), beside `bound_ms` (over the published peak);
  kernels  each score kernel against its plain PyTorch version on the
           card, bit for bit, for global, local, overlap, edit, fit and
           fit+jump at B=64 ragged pairs of (512, 2048), plus local at the
           bench.py shape 256 x 2048^2 and fit+jump at 64 x (512 x 32768);
           warm median times of both (CUDA events); and, as a record, the
           same fill through the blocked kernel at min(n_pad, 8,192)
           columns a block, held against plain and timed (`blocked_ms`);
           each row names its route (`route`: the register-strip score
           fill or, past its cap, the blocked one); then the global,
           local, overlap, fit, fit+jump and edit route across the
           register-strip fills' caps (`cap`: 4,224 to 32,768 columns,
           flat up to scan.flat_cap(mode), each against plain and timed
           beside the blocked fill at every column block, `c_blk_ms`) and
           every score fill on the tie inputs of tests/ptr_ties.py
           (`ties`);
  ptr      the registers and local (spill) bytes of each instance of
           csrc/ptr_fill.cu, the score fills included (cuobjdump
           --dump-resource-usage); then the
           pointer fill through the rows path's route (ops/ptr.ptr_fill:
           the flat kernel up to ops/ptr.FLAT_REG_MAX_N_PAD columns, else
           the blocked one with a ragged last block) against its plain
           version, bit for bit (score, start info and every pointer
           byte): global, local, fit and overlap at rows-per-byte 1 and 2,
           fit+jump at 1, overlap at 4, all at 64 ragged pairs of (512,
           2048); local at 256 x 2048^2 (rpb 2, 512 MB of pointers);
           fit+jump at 64 x (512 x 32768) (rpb 1, 1 GB); local at the
           largest bucket of the slice phase's 20,000-pair rows run; local
           rpb 2 at 64 x (512 x (FLAT_REG_MAX_N_PAD + 384)), ragged at
           every column block; each also through the blocked kernel at
           every column block of the sweep up to n_pad (`c_blk_ms`), held
           to the same bytes and timed; the cap sweep (`cap`: the flat
           kernel against the blocked one at 4,224, 6,144 and 8,192
           columns) and the tie inputs of tests/ptr_ties.py (`ties`); then
           the walk kernel against its
           plain version on
           each of those pointer tensors (every column and scalar), timed
           through its wrapper (`ms`) and alone (`kernel_ms`), with
           `chain_ms` beside the bound: the longest walk at
           WALK_CHAIN_CYCLES a step; then (`walk`, `drawn_cases`) on every
           walk of tests/walk_cases.py, drawn to cross the kernel's
           pointer tiles (flat at rpb 1, 2 and 4; window at W 64, 128 and
           300);
  blocked  the column-blocked kernels (targets past 32,768 columns; a
           wavefront of one CTA per (pair, column block)) against their
           plain versions, bit for bit, at column blocks 8,192, 4,096 and
           2,048: L1, the six score variants and the pointer fill at ten
           (mode, rows-per-byte) layouts on 8 ragged pairs in a (1,024,
           65,536) bucket, timed at the kernels' own column block; L2,
           fit+jump score and pointer fills at the reference fixture's
           shape, 64 pairs of 1,327 x 114,491 (9.75 GB of pointers), and
           B1, one such pair, each timed at every column block; warm
           median times of both;
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
                     tests hold that against the JAX package);
             trace   `batch global` rows on the 2,000 once more untraced,
                     then twice with `--trace DIR`: the Chrome trace holds
                     kernel events of the pointer fill and the walk, every
                     TSV equals the rows run's; the wall of each;
  buckets  meanwhile, every fourth bucket those runs built, on the card:
           the score kernel against plain for the score runs, and the
           pointer kernel against plain for the rows runs, with the walk
           against plain on every bucket checked of the 20,000-pair local
           run and on every 32nd bucket of the 2,000-pair runs, whose
           walks cross the whole target;
  single   the per-mode commands (`global|local|fit|overlap|edit [opts]
           FILE`) through cli.main in-process on the card
           (ALIGNTOOLS_DEVICE unset), the counts set to 0 just before and
           read just after (the pointer fill, the walk, edit's score fill
           and both blocked fills launched, no plain version ran): the CPU
           tests' test/*.fa invocations, one seeded 2,048 x 2,048 DNA pair
           a mode, one fit -s pair of the fit fixture's 1,327 x 114,491
           (three junction sites, the blocked pointer fill) and one edit
           pair of 2,048 x 20,480 (the blocked score fill); every stdout
           byte for byte the same command's with ALIGNTOOLS_DEVICE=cpu
           (in-process; the two long ones in one-thread processes beside
           the timings). Then warm api.align_pair medians per pair, one
           warm call of the 2,048^2 global pair and of the long fit pair
           under torch.profiler (device time against wall), the cold wall
           of `python3 -m aligntools_tpu_torch global test/test_global.fa`
           in a fresh process with the kernels built (one process), its
           split (import torch, the library load, the first CUDA call, the
           command), and the native C++ CLI (native/aligntools_cli.cpp,
           built here by native.cli_binary) on the same command;
  serve    serve() fed one stream on the slice phase's 2,000-pair FASTA:
           overlap scores_only, global (rows), fit sites (rows), edit, the
           first again, a malformed line, an overlap sharded request (a
           one-rank NCCL group), quit and a line after it: each request's
           TSV byte for byte the batch TSV the slice phase wrote for the
           same mode and output (the sharded one: overlap's scores), #done
           pairs=2000 on each, one #error line, nothing read after quit;
           each request's seconds and pairs/s, and its launches;
  parallel the parallel package (aligntools_tpu_torch/parallel/): `batch
           MODE --sharded` on a one-rank NCCL group for the five modes (fit
           -s) on every 8th pair of the 2,000, each TSV byte for byte the
           `--scores-only` one; the EDGE score instances (six variants) at
           one 256-row chunk of rank 1 of 4 of the B1 shape, the EDGE
           pointer instances (global, local, overlap, fit+jump) at one
           chunk of rank 1 of 4 of a related 2,050 x 20,480 pair and the
           column-paused walk over its rank-3 slab, each against its plain
           version on the CPU, bit for bit, and timed; then the main path
           (seqpar_score on B1, seqpar_batch_scores on L1's pairs,
           seqpar_align on the related pair) at one rank, the counts set to
           0 just before and read just after, and by 4 gloo ranks spawned on
           the one card (the script itself with --rank), each result equal
           to the single-device route's of the same run; seqpar_score's
           fit+jump on B1 timed at D 1 beside the blocked route and at D 4
           (time-sliced on one card: no scaling figure);
  long     the port's main path on long targets through cli.main (L3):
           `batch fit -s` on 256+ seeded pairs (m ~ 1,300, n 40,000 to
           131,072, three junction sites each; enough that the pointer
           budget splits the rows run into two or more waves), rows cold
           and warm and `--scores-only`; `batch global` and `batch local`
           on its first 4 pairs; `batch local` on the first 2,000
           clustered pairs plus 32 long ones (flat and blocked buckets in
           one run). The blocked kernels launched, no plain version ran;
           L3 runs at the kernels' own column block only (the blocked phase
           holds the kernels at the others);
           each rows TSV's score column equals its scores TSV, and 4 lines
           sampled from the 16 cheapest long pairs with n <= 60,000 (and,
           for L3, the cheapest pair with n > 100,000) equal the port's
           `--device cpu` run. Then one more warm L3 rows run under
           torch.profiler (as `--profile` below; its trace in the work
           directory without it): the walk's time, its share of the busy
           time, its SMs in use and how much of it ran under a fill.
           Meanwhile (`buckets` lines) every eighth L3 bucket's fill (every
           second of the mixed run's, every one of L3g / L3l) against plain
           on the card, the walk on every flat bucket checked and on L3's
           blocked bucket of the narrowest target.
  rescan   the checkpoint-rescan route of the rows path (engine/rescan.py).
           RSF: batch.align_batch with ALIGNTOOLS_HBM_BUDGET just below one
           pair's pointer bytes (the counts set to 0 just before and read
           just after: the checkpoint forward, the refill and the paused
           walk launched, no whole-matrix pointer fill and no plain version
           ran), on the B1 shape (fit -s, three junction sites) and on
           seeded related 2,048 x 20,480 pairs (utils/synth.related_pair;
           overlap's query drawn from the target's start) in global, local
           and overlap (S 256, 9 row blocks); each pair's
           rows byte-equal to the normal
           route's at the true budget (the CPU holds those in single and
           long). Then, at each of those pairs' shapes and strides, the
           checkpoint forward, the refill of the row block the walk starts
           in and the paused walk there against their plain versions, bit
           for bit, timed beside their bounds. RSR: global on a seeded
           related pair (utils/synth.related_pair, n = 1.375 m) sized from
           torch.cuda.mem_get_info() so that its packed pointers pass
           PTR_BUDGET_FRAC of the card's memory by 7.5%, at the true budget:
           its score bit-equal to the score route's (align_batch without
           traceback: the blocked score fill), its rows rescored on the host
           to that score and, without gaps, the pair; S and the row blocks,
           the forward, refill and walk ms (CUDA events around each call)
           beside their bounds, the wall, true-cell GCUPS and the peak
           device memory beside the budget and the card's.
  validate the port's differential campaign (aligntools_tpu_torch.tools.
           validate, the counterpart of tools/validate.py) in this process
           on the card at n_per VALIDATE_N_PER: randomized pairs (DNA,
           binary, homopolymer, protein; degenerate parameter sets) through
           align_pair and batches, the per-mode commands, the rescan, the
           banded engine (full band on both paths, certified auto band),
           seqpar on 4 and 8 loopback ranks and the routes' crossovers,
           each result against the native C++ CLI's stdout; each section's
           cases, skips and seconds; every kernel it reaches launched, no
           plain version and no double instance ran.

  exact64  single pairs past float32's exact integers, on the double
           instances of the fills (api.align_pair's route for them). The
           main path, the counts set to 0 just before and read just after:
           the per-mode commands (`MODE -m 1048573 -u -1048571 -o -3145739
           -e -1048577 FILE` through cli.main in-process on the card) on a
           seeded 2,048^2 pair a mode, a global 2,048 x 8,192 pair (past
           the double pointer fill's 4,096 columns: the blocked fill) and
           an edit 2,048 x 20,480 pair (past the double edit fill's 8,192),
           and the global one again through the checkpoint rescan under
           ALIGNTOOLS_HBM_BUDGET (as RSF): every double instance, the walk
           and the paused walk launched, no float32 instance and no plain
           version; every stdout byte for byte the native C++ CLI's
           (native/aligntools_cli.cpp, which computes in double),
           the rescan's the normal route's; `batch` refuses the pair. Then
           the double instances' registers and spills (cuobjdump) and each
           against its float64 plain version, bit for bit, timed beside
           its bound at the FP64 rate (PEAK_OPS_F64) and its probe_ms (the
           probe's float64 rate): the flat pointer fill at every (mode,
           rpb) of K1's inputs, edit's flat fill there, and at the B1
           shape the blocked FILL (fit+jump), the CKPT forward, one SEED
           refill with the paused walk, and edit's blocked fill;
  banded   the banded path (`--band`). BK1: the banded kernel's nine
           variants (scores for all five modes, pointers for global, local,
           fit and overlap) against their plain versions, bit for bit, at 64
           x 4,096 (W = 128) and 2,048 x 512 (W = 64), similar pairs (1%
           substitutions, m = n), warm medians of both, GCUPS over band
           cells and over true cells. BS: the port's main path through
           cli.main on 20,000 seeded long-read-vs-consensus pairs (m
           lognormal, median 2,000, sigma 0.2; the target is the query with
           1% substitutions and 0.5% single-base indels) at `--band 128`:
           `batch local` and `batch global` rows cold and warm and
           `--scores-only`; on the first 2,000 `batch overlap`, `batch fit`
           (targets with a 64-base random tail, so m <= n), rows and scores,
           and `batch edit`. The banded kernel and the walk launched, no
           plain version ran; each rows TSV's score column equals its scores
           TSV, and 64 sampled lines equal the port's `--device cpu` run.
           Meanwhile (`buckets` lines) every slab of those runs (every
           eighth of BS local and global), kernel against plain on the card (one plain call a slab holds both the
           rows run's pointer fill and the scores run's score fill), and the
           walk against plain on each rows run's first slab; the kernel
           timed on each mode's first rows slab and first scores slab
           (`BS-slab` lines: ms, bound, band-GCUPS). Before BK1, the
           registers and local bytes of each csrc/banded_fill.cu instance;
           each BK1 row names its launch's path and strip and holds the
           CTA path too against plain (`cta_ms`); after it (`paths` lines)
           both paths against plain at W 200, where the warp path takes
           16 lanes a thread, at 64 pairs of 512 rows; then
           BKW, the CTA path at the bands only it serves (W 256 and 1,000
           at 64 x 4,096, W 2,048 at 16 x 4,096, W 8,191 at 8 x 2,048 rows
           against targets 8,191 bases longer: a cluster of 16 CTAs), the
           nine variants against plain (one plain call a mode), timed
           beside the bound, probe_ms, the team's geometry and the parent
           commit's time (BKW_PARENT_MS). After BS, BW: the CTA path on
           the main path, `batch local|global --band 512` rows and scores
           through cli.main on 512 noisy long reads against their draft
           (lognormal, median 10,000, sigma 0.2; 5% substitutions, 3%
           deletions, 1% insertions), its launches counted from 0 (the
           CTA path and the walk launched, every banded fill on the CTA
           path, no plain version), each rows TSV's score column equal to
           its scores TSV; a local rows run with `--trace DIR` in a fresh
           process, its TSV the rows run's (the device's busy share of
           its pipeline's seconds, from the trace: a `BW` `trace` line);
           local's first slab, the pointer and score fills against one
           plain call, the kernel timed there (`BW-slab` lines: ms, bound,
           band-GCUPS). BKW also holds the CTA path in chunks past the
           one-pass width (W 32,768 and 40,000 at 2 x 256 rows, 2 chunks a
           warp; W 131,071 at 1 x 256, 4) beside one pass at W 32,767 (2 x
           256), targets W bases longer. After
           BW, BU: the CTA path in chunks on the main path, `batch local
           --band 40000` through cli.main (cold, then warm) on 4 reads of
           200-400 bases inside targets of ~40,300, its launches counted
           from 0 (the chunked CTA instances and the walk launched, no
           plain version), its TSV equal to the port's `--device cpu` run
           of the same command (started before BS, beside BS and BW); then
           engine/banded.banded_score_auto on an unrelated 64 x 40,064
           local pair, counted alike (two chunked fills as the band
           doubles to cover the matrix): its score the unbanded route's,
           (score, band, certified) the plain route's on the CPU.

Last, after the banded phase:

  calibrate  engine/autotune.calibrate(force=True) into a temporary
             ALIGNTOOLS_TORCH_CACHE (no table is left behind to change
             later runs), under CAL_SECONDS: the table and its raw timings;
             then a sample of S2's pairs (every eighth, rows and scores),
             of L3's (the 8 shortest targets, fit -s rows and scores,
             local rows) and of BS's (512 pairs, local and global rows at
             W 128) under the measured table and under CAL_MOVED, which
             moves every key off its default: every result byte-equal to
             the default route's. Before those, `BS-band` lines: the
             banded kernel at W 128 (local pointers, 64 to 1,024 pairs of
             2,048 rows) on the path each of the default and the measured
             table picks, timed in turns.

The `--device cpu` runs of the sampled pairs go in processes of one thread
each, beside the bucket checks, which are the longest phases.

    python3 chip_smoke.py --profile TRACE.json

adds a `profile` phase: one more warm rows `batch local` run on the 20,000
pairs, one more warm L3 `batch fit -s` rows run and one more warm BS
`batch local --band 128` rows run under torch.profiler,
with the device's time per op and its split between fill, walk,
copies and allocation (the zero fills of new tensors), the busy time (the
union of the device's spans: each walk runs on its own stream, under the
next fill) against the wall, the walk's time under a fill, the SMs in use
of the fill and of the walk (min(SMs, a launch's CTAs), weighted by
device time),
and their Chrome traces written to TRACE.json, TRACE.long.json and
TRACE.banded.json.

Then the kernels' summary line (each kernel's time, launches on the main
path, bound, probe_ms and plain time; the banded kernel's first BS
slab beside BK1; its CTA path, `banded_cta`, at BKW's W 1,000 with BW's
launches and first slab, and BKW's widest shapes (W 32,767 to 131,071)
with BU's chunked launches beside; the double instances with their exact64
launches), the
card's name and power limit as
nvidia-smi prints them, and, last, {"ok": true, "device": {...}}. Any
failure exits nonzero before that line; so does a host without CUDA.
"""

import argparse
import contextlib
import datetime
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
INT32_MAX = 2**31 - 1

# kernel -> (its TPU counterpart, source, the variants that run it)
KERNELS = {
    "affine": ("aligntools_tpu/ops/pallas_scan.py:328 _affine_kernel",
               "ptr_fill.cu", ("global", "local")),
    "overlap": ("aligntools_tpu/ops/pallas_scan.py:421 _overlap_kernel",
                "ptr_fill.cu", ("overlap",)),
    "edit": ("aligntools_tpu/ops/pallas_scan.py:469 _edit_kernel",
             "ptr_fill.cu", ("edit",)),
    "fit": ("aligntools_tpu/ops/pallas_scan.py:513 _fit_kernel",
            "ptr_fill.cu", ("fit", "fit+jump")),
    "ptr": ("aligntools_tpu/ops/pallas_ptr.py:85 _ptr_kernel",
            "ptr_fill.cu", ()),
    "walk": ("aligntools_tpu/engine/device_tb.py:56 _walk_affine, "
             ":166 _walk_overlap", "walk.cu", ()),
    "blocked_scores": ("aligntools_tpu/ops/pallas_blocked.py:48 "
                       "_blocked_affine_kernel (entry blocked_scores:332)",
                       "blocked_fill.cu", ()),
    "blocked_ptr": ("aligntools_tpu/ops/pallas_blocked.py:375 "
                    "_blocked_ptr_kernel (entry blocked_ptr_fill:764)",
                    "blocked_fill.cu", ()),
    "banded": ("aligntools_tpu/ops/pallas_banded.py:61 _banded_kernel "
               "(entries banded_pallas_scores:356, banded_pallas_full:369)",
               "banded_fill.cu", ()),
    # the banded fill's CTA path: a team of warps a pair (clusters past a
    # CTA), every band past W 255 and batches below a strip's threshold
    "banded_cta": ("aligntools_tpu/ops/pallas_banded.py:61 _banded_kernel "
                   "(entries banded_pallas_scores:356, banded_pallas_full:"
                   "369), its CTA path", "banded_fill.cu", ()),
    "blocked_ckpt": ("aligntools_tpu/engine/rescan.py:71 _forward_ckpt (a "
                     "lax.scan over engine/scan.py's row machines; no "
                     "pallas_call)", "blocked_fill.cu", ()),
    "blocked_refill": ("aligntools_tpu/engine/rescan.py:96 _refill_block (a "
                       "lax.scan over the same machines; no pallas_call)",
                       "blocked_fill.cu", ()),
    "walk_pause": ("aligntools_tpu/engine/device_tb.py:56 _walk_affine, :166 "
                   "_walk_overlap(pause_at_i0=True), as engine/rescan.py:"
                   "170-242 resumes them block by block", "walk.cu", ()),
    # the double instances: a single pair past float32's exact integers,
    # which the JAX align_pair sends to its double-precision spec engine
    # (aligntools_tpu/api.py:54-63)
    "ptr64": ("aligntools_tpu/ops/pallas_ptr.py:85 _ptr_kernel (its double "
              "instance)", "ptr_fill.cu", ()),
    "edit64": ("aligntools_tpu/ops/pallas_scan.py:469 _edit_kernel (its "
               "double instance)", "ptr_fill.cu", ()),
    "blocked_ptr64": ("aligntools_tpu/ops/pallas_blocked.py:375 "
                      "_blocked_ptr_kernel (its double instance)",
                      "blocked_fill.cu", ()),
    "blocked_edit64": ("aligntools_tpu/ops/pallas_blocked.py:48 "
                       "_blocked_affine_kernel (edit; its double instance)",
                       "blocked_fill.cu", ()),
    "blocked_ckpt64": ("aligntools_tpu/engine/rescan.py:71 _forward_ckpt "
                       "(its double instance; no pallas_call)",
                       "blocked_fill.cu", ()),
    "blocked_refill64": ("aligntools_tpu/engine/rescan.py:96 _refill_block "
                         "(its double instance; no pallas_call)",
                         "blocked_fill.cu", ()),
    # the EDGE phase of the blocked fills and the walk's column pause: the
    # port's sequence parallelism, where the JAX package runs engine/scan.py's
    # row machines under shard_map (no pallas_call)
    "edge_scores": ("aligntools_tpu/ops/pallas_blocked.py:48 "
                    "_blocked_affine_kernel, its EDGE phase (for "
                    "aligntools_tpu/parallel/seqpar.py:78 _seqpar_local_fn, a "
                    "lax.scan under shard_map)", "blocked_fill.cu", ()),
    "edge_ptr": ("aligntools_tpu/ops/pallas_blocked.py:375 "
                 "_blocked_ptr_kernel, its EDGE phase (for aligntools_tpu/"
                 "parallel/seqpar.py:236 _seqpar_local_ptr_fn)",
                 "blocked_fill.cu", ()),
    "walk_col_pause": ("aligntools_tpu/engine/device_tb.py:56 _walk_affine, "
                       ":166 _walk_overlap, as aligntools_tpu/parallel/"
                       "seqpar.py:552 walks the slabs", "walk.cu", ()),
    "probe_chain": ("tools/vpu_probe.py:77 vmem_ceiling (body :90-97, call "
                    ":101)", "vpu_probe.cu", ()),
    "probe_ilp": ("tools/vpu_probe.py:124 roofline_ops_per_sec (body "
                  ":143-156, call :161), :177 vpu_roofline (body :192-205, "
                  "call :210)", "vpu_probe.cu", ()),
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
# the kernels phase's score-fill crossover: the route of each variant of
# SCORE_CAP_VARIANTS at each n_pad, at (B, m_pad) of SCORE_CAP_SHAPE[n_pad
# <= the flat cap]
SCORE_CAP_N_PADS = (4224, 6144, 8192, 16384, 32768)
SCORE_CAP_SHAPE = {True: (128, 512), False: (64, 512)}
SCORE_CAP_VARIANTS = ("local", "global", "overlap", "fit", "fit+jump", "edit")
# the ptr phase's ragged wide row: (B, m_pad), at n_pad FLAT_REG_MAX_N_PAD +
# PTR_WIDE_EXTRA, which no column block of the sweep divides; the cap
# sweep: (B, m_pad, mode, jump, rpb) at each n_pad of PTR_CAP_N_PADS, the
# flat kernel against the blocked one
PTR_WIDE = (64, 512)
PTR_WIDE_EXTRA = 384
PTR_CAP_CASES = [(128, 512, "local", False, 2), (64, 512, "fit", True, 1)]
PTR_CAP_N_PADS = (4224, 6144, 8192)
# the blocked phase: L1 (B, m_pad, n_pad), ragged; L2 (B, m_pad, n_pad, m,
# n), the reference's fit fixture (test/tmp.fa, 1,327 x 114,491); B1, one
# pair of the fixture's shape; each held against plain at every column
# block of the sweep, L2 and B1 timed at each; the flat shapes' blocked
# fills at min(n_pad, FLAT_AS_BLOCKED_C_BLK) columns a block
BLOCKED_L1 = (8, 1024, 65536)
BLOCKED_L2 = (64, 1328, 114688, 1327, 114491)
BLOCKED_B1 = (1, 1328, 114688, 1327, 114491)
C_BLK_SWEEP = (8192, 4096, 2048)
FLAT_AS_BLOCKED_C_BLK = 8192
# the long-target slice (L3): pairs; the CPU-checked samples are drawn
# from the LONG_POOL cheapest long pairs (m * n) with a target of at most
# LONG_SAMPLE_MAX_N (the plain versions on the CPU: ~15 s a pair), plus,
# for L3 itself, the cheapest pair with a target past LONG_FAR_N
LONG_PAIRS = 256
LONG_AFFINE_PAIRS = 4  # L3g / L3l: global and local on the first of them
LONG_SAMPLES = 4
LONG_POOL = 16
LONG_SAMPLE_MAX_N = 60000
LONG_FAR_N = 100000
# the banded phase: BK1 (B, m = n, W), benchmarks/probe_banded.py's shapes;
# BS pairs, the run's band, and the share of the pairs the slower modes run
BANDED_BK1 = [(64, 4096, 128), (2048, 512, 64)]
# the warp path's widest strip (16 lanes a thread) against the CTA path at
# a few pairs: the nine variants at BANDED_PATHS_L rows, each (band,
# pairs); BK1 holds the CTA path at its own shapes
BANDED_PATHS = [(200, 64)]
BANDED_PATHS_L = 512
BANDED_VARIANTS = [("global", True), ("local", True), ("fit", True),
                   ("overlap", True), ("global", False), ("local", False),
                   ("fit", False), ("overlap", False), ("edit", False)]
BS_PAIRS = 20000
BS_SMALL = 2000
BS_BAND = 128
# BKW: the CTA path at bands only it serves, (B, m, W, target bases past
# m): a team of 5 warps in a CTA (W 256) and a cluster of 2 CTAs (W 1,000)
# at 64 x 4,096, one of 5 at W 2,048 (where the old kernel took 16-lane
# strips), and one of 16 at W 8,191, against targets 8,191 bases longer;
# then 2 x 256 rows at the one-pass width (W 32,767, a cluster of 16 CTAs)
# and one past it, W 32,768 and 40,000 (two chunks a warp), and 1 x 256 at
# W 131,071 (four), targets W bases longer
BANDED_BKW = [(64, 4096, 256, 0), (64, 4096, 1000, 0), (16, 4096, 2048, 0),
              (8, 2048, 8191, 8191), (2, 256, 32767, 32767),
              (2, 256, 32768, 32768), (2, 256, 40000, 40000),
              (1, 256, 131071, 131071)]
# the widest ones, one pass at W 32,767 and the chunked ones past it, which
# the kernels line carries
BKW_WIDE = ("/W32767/", "/W32768/", "/W40000/", "/W131071/")
# the parent commit's (7532830) CTA kernels at BKW, ms by "variant shape":
# the mean of two runs of this script's BKW level (`--only bkw`) on that
# commit's package, in turns with this one, one H100 80GB HBM3 at 700 W
BKW_PARENT_MS = {
    "global/ptrs 64x4096/W256": 9.1476,
    "local/ptrs 64x4096/W256": 9.0305,
    "fit/ptrs 64x4096/W256": 8.7793,
    "overlap/ptrs 64x4096/W256": 7.7072,
    "global 64x4096/W256": 7.8486,
    "local 64x4096/W256": 7.7493,
    "fit 64x4096/W256": 7.7800,
    "overlap 64x4096/W256": 7.5643,
    "edit 64x4096/W256": 7.5693,
    "global/ptrs 64x4096/W1000": 10.7176,
    "local/ptrs 64x4096/W1000": 11.1320,
    "fit/ptrs 64x4096/W1000": 10.7281,
    "overlap/ptrs 64x4096/W1000": 9.6971,
    "global 64x4096/W1000": 9.7952,
    "local 64x4096/W1000": 10.0970,
    "fit 64x4096/W1000": 9.7734,
    "overlap 64x4096/W1000": 9.5853,
    "edit 64x4096/W1000": 9.5268,
    "global/ptrs 16x4096/W2048": 11.3180,
    "local/ptrs 16x4096/W2048": 12.2548,
    "fit/ptrs 16x4096/W2048": 10.9027,
    "overlap/ptrs 16x4096/W2048": 10.4217,
    "global 16x4096/W2048": 10.1705,
    "local 16x4096/W2048": 11.2667,
    "fit 16x4096/W2048": 10.1810,
    "overlap 16x4096/W2048": 10.0011,
    "edit 16x4096/W2048": 10.2304,
    "global/ptrs 8x2048/W8191/n+8191": 6.6763,
    "local/ptrs 8x2048/W8191/n+8191": 7.4394,
    "fit/ptrs 8x2048/W8191/n+8191": 6.4678,
    "overlap/ptrs 8x2048/W8191/n+8191": 6.1400,
    "global 8x2048/W8191/n+8191": 5.8144,
    "local 8x2048/W8191/n+8191": 6.6409,
    "fit 8x2048/W8191/n+8191": 5.8013,
    "overlap 8x2048/W8191/n+8191": 5.6656,
    "edit 8x2048/W8191/n+8191": 5.8119,
}
# BW: noisy long reads against their draft at a band past the warp path
# (the CTA path: a cluster of 2 CTAs a pair); pairs, band, the draft's
# median length and sigma, and the read's substitution, deletion and
# insertion rates
BW_PAIRS = 512
BW_BAND = 512
BW_MEDIAN = 10000
BW_SIGMA = 0.2
BW_ERRORS = (0.05, 0.03, 0.01)
# BU: reads of 200-400 bases inside targets of ~40,300 at a band past the
# one-pass width (two chunks a warp), and the auto pair's (m, n)
BU_BAND = 40000
BU_PAIRS = 4
BU_AUTO = (64, 40064)
# the rescan phase: RSF, the rows path's checkpoint rescan forced by an
# ALIGNTOOLS_HBM_BUDGET just below one pair's pointer bytes, on the B1 shape
# (fit -s) and on seeded related RSF_SHAPE pairs in global, local and
# overlap (the query drawn from the target's start for overlap), whose
# alignments cross every row block; RSR, global
# on a seeded related pair (utils/synth.related_pair, n = RSR_ASPECT * m: a
# contig against its region) whose packed pointers pass the true budget by
# a factor RSR_OVER
RSF_SHAPE = (2048, 20480)
# the exact64 phase: the per-mode commands' options past float32's exact
# integers (odd params near 2^20; every 2,048^2 pair passes 2^24), the jump
# its kernel checks use, the wide pairs (global past the double pointer
# fill's 4,096 columns, the rescan's pair too; edit past the double edit
# fill's 8,192) and the stride of the double CKPT / SEED checks at B1
EXACT64_OPTS = ("-m", "1048573", "-u", "-1048571", "-o", "-3145739", "-e",
                "-1048577")
EXACT64_JUMP = -2097143
EXACT64_WIDE = [("global", 2048, 8192), ("edit", 2048, 20480)]
EXACT64_STRIDE = 256
# the calibrate phase: its time limit, the sample it re-runs, and a valid
# table that moves every key off its default
CAL_SECONDS = 60
CAL_S2_EVERY = 8
CAL_L3_PAIRS = 8
CAL_BS_PAIRS = 512
# the banded kernel at BS's band under the default and the measured table
CAL_BS_BATCHES = (64, 256, 1024)
CAL_BS_L = 2048
CAL_TURNS = 3
CAL_MOVED = {"score_flat_cap": {"affine": 2048, "overlap": 4096,
                                "edit": 4096},
             "ptr_flat_cap": {"float32": 2048, "float64": 2048},
             "blocked_c_blk": 1024,
             "banded_bmin": {"5": 1 << 20, "9": 1 << 20, "16": 1 << 20}}
# the validate phase: main's cases a mode (the other sections scale from
# it), and the kernels its sections reach, each of which must launch
VALIDATE_N_PER = 24
VALIDATE_KERNELS = ("affine", "overlap", "edit", "fit", "ptr", "walk",
                    "blocked_scores", "blocked_ptr", "blocked_ckpt",
                    "blocked_refill", "walk_pause", "banded", "banded_cta",
                    "edge_scores", "edge_ptr", "walk_col_pause")
RSR_OVER = 1.075
RSR_ASPECT = 1.375
# the slice phase holds the walk against plain on every bucket of the
# 20,000-pair local rows run and on every SMALL_WALK_EVERY-th bucket of the
# 2,000-pair global, overlap and fit -s rows runs (two walks of each: the
# plain walk crosses the whole target, ~2-4 s a bucket)
SMALL_WALK_EVERY = 32
# the bucket checks on the card hold every SLICE_CHECK_EVERY-th bucket of
# the slice phase's runs, every LONG_CHECK_EVERY[run]-th of the long
# phase's (the narrowest blocked bucket of L3 always) and every
# BS_CHECK_EVERY-th slab of BS local and global (the first always): a
# sample that keeps every kernel, mode and route covered and the script
# inside its time
SLICE_CHECK_EVERY = 4
LONG_CHECK_EVERY = {"fit": 16, "mixed": 2}
BS_CHECK_EVERY = 8

# The least time the card could take for the same work: the
# larger of the operations over 33.5 T op/s (67 TFLOP/s of f32 counts an
# FMA as two; each add, max/min and compare is one op) and the bytes
# moved (each input read once, each output written once) over 3.35 TB/s.
PEAK_OPS = 33.5e12
PEAK_BYTES = 3.35e12
# the double instances' operations: the H100's FP64 rate outside the tensor
# cores is half its FP32 rate (34 against 67 TFLOP/s on the data sheet)
PEAK_OPS_F64 = PEAK_OPS / 2
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
# The walk's chain bound, beside the bytes and operations (which a chain of
# dependent steps comes nowhere near): a bucket's longest walk, each step
# one dependent load from shared memory, assumed WALK_CHAIN_CYCLES SM
# clocks (the load's latency, the decode left out), at the SM clock the
# probe read under load. It bounds a walk that takes its steps one after
# another; the kernel takes a run of up to 32 steps in one state at once.
WALK_CHAIN_CYCLES = 30


def bound(ops, nbytes, f64=False):
    t_ops = ops / (PEAK_OPS_F64 if f64 else PEAK_OPS) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# the card's chained max+add rates in op/s, measured by the probe phase
# (roofline_ops_per_sec at its defaults) before any fill is timed
PROBE_RATES = {}
SM_MHZ = {}  # the SM clock nvidia-smi read under the int32 roofline probe


def probe_ms(ops, integer=False, f64=False):
    """The counted ops over the measured rate: float32's, int32's for the
    int32 fills (edit) and the walk, or float64's for the double
    instances."""
    key = "float64" if f64 else "int32" if integer else "float32"
    return ops / PROBE_RATES[key] * 1e3


T0 = time.perf_counter()


def emit(obj):
    if "phase" in obj:  # seconds since the start, for the phase budget
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
    print(json.dumps(obj), flush=True)


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def smi_query(fields, fmt="csv,noheader,nounits"):
    """nvidia-smi's first line for ``fields`` of the card."""
    r = subprocess.run(
        ["nvidia-smi", f"--query-gpu={fields}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60, check=True)
    return r.stdout.strip().splitlines()[0]


def nvidia_smi_line():
    return smi_query("name,power.limit", "csv,noheader")


# the probe phase: each variant against plain at the JAX shapes (one chain:
# vmem_ceiling's, several: the ILP probes') and at an odd element count,
# PROBE_CHECK_CHAIN links; a reading above PROBE_GUARD of the issue
# ceiling (128 instructions an SM a clock at the card's top SM clock, times
# the ops an instruction does where a link takes the fewest instructions it
# can) fails, and so does a chain loop in the SASS that lacks a link's ops
PROBE_CHECK_CHAIN = 64
PROBE_SHAPES = {1: (32, 1024), 8: (64, 2048)}
PROBE_RAGGED = (37, 129)
PROBE_GUARD = 1.05
LANES_PER_SM_CLOCK = 128
CHAIN_UNROLL = 4  # the `#pragma unroll` of csrc/vpu_probe.cu's chain loop
# a double max: DMNMX, or DSETP.MAX (the compare) with its selects
SASS_MAX = ("FMNMX", "IMNMX", "VIMNMX", "VIADDMNMX", "HMNMX2", "DMNMX",
            "DSETP.MAX")
SASS_ONE_OP = ("FADD", "VIADD", "HADD2", "HFMA2", "IMAD.IADD",
               "DADD") + SASS_MAX
SASS_FORMS = {"F32": ("float32", "plain"), "F64": ("float64", "plain"),
              "I32": ("int32", "plain"),
              "I32Dpx": ("int32", "dpx"), "I16": ("int16", "plain"),
              "I16x2Dpx": ("int16", "dpx"), "BF16x2": ("bfloat16", "x2")}


def smi_under_load(torch, vp, load):
    """(clocks.sm MHz, power.draw W) as nvidia-smi reads them while
    ``load`` runs on the card again and again, until the query returns. The
    load's launches are left out of the probe's counts."""
    import threading

    box, counts = {}, dict(vp.launches)

    def query():
        try:
            box["out"] = smi_query("clocks.sm,power.draw")
        except Exception as err:  # re-raised below, in the caller
            box["err"] = err

    th = threading.Thread(target=query)
    th.start()
    while th.is_alive():
        load()
        torch.cuda.synchronize()
    th.join()
    vp.launches.update(counts)
    if "err" in box:
        raise box["err"]
    clk, power = (f.strip() for f in box["out"].split(","))
    try:
        return float(clk), float(power)
    except ValueError:  # a card that reports no power draw ("[N/A]")
        return float(clk), None


def sass_ops(opcode, operands):
    """Adds, subtracts and maxes one SASS instruction does on a register:
    2 for a fused add-max, an IADD3 one fewer than its sources."""
    import re

    if opcode.startswith("VIADDMNMX"):
        return 2
    if opcode.startswith(SASS_ONE_OP):
        return 1
    if opcode == "IADD3":
        return sum(not re.fullmatch(r"!?U?P(T|\d)|U?RZ", o)
                   for o in operands[1:]) - 1
    return 0


def sass_chain_loops(sass):
    """Per chain_kernel instantiation (dtype, form, width) of a
    ``cuobjdump -sass`` listing, each innermost loop that holds a max:
    its instructions, maxes and ops (``sass_ops``)."""
    import re

    code, key = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            m = re.search(r"chain_kernelINS_(\d+)(\w+?)ELi(\d+)E", line)
            key = m and (*SASS_FORMS[m.group(2)[:int(m.group(1))]],
                         int(m.group(3)))
            if key:
                code[key] = []
            continue
        ins = re.match(r"\s*/\*([0-9a-f]+)\*/\s+(?:@!?U?P\w+\s+)?"
                       r"([A-Z][A-Z0-9_.]*)\s*([^;]*);", line)
        if key and ins:
            ops = [o.strip() for o in ins.group(3).split(",") if o.strip()]
            code[key].append((int(ins.group(1), 16), ins.group(2), ops))
    out = {}
    for key, ins in code.items():
        back = [(int(ops[0], 16), at) for at, op, ops in ins
                if op == "BRA" and int(ops[0], 16) < at]
        out[key] = []
        for lo, hi in back:
            if any(lo <= l2 and h2 <= hi and (l2, h2) != (lo, hi)
                   for l2, h2 in back):
                continue  # holds another loop
            body = [(op, ops) for at, op, ops in ins if lo <= at <= hi]
            maxes = sum(op.startswith(SASS_MAX) for op, _ in body)
            if maxes:
                out[key].append({"instructions": len(body), "maxes": maxes,
                                 "ops": sum(sass_ops(*i) for i in body)})
    return out


def sass_check(loops, variants, ops_per_link):
    """Raises unless every variant has chain loops, the largest with
    CHAIN_UNROLL * width maxes or more, and each loop at least
    ``ops_per_link`` ops a max: a folded chain has fewer."""
    for dtype, form, width in variants:
        mine = loops.get((dtype, form, width))
        check(mine, f"SASS: no chain loop for {dtype}/{form}/{width}")
        top = max(lp["maxes"] for lp in mine)
        check(top >= CHAIN_UNROLL * width, f"SASS {dtype}/{form}/{width}: "
              f"{top} maxes in the chain loop, below {CHAIN_UNROLL * width}")
        for lp in mine:
            check(lp["ops"] >= ops_per_link * lp["maxes"],
                  f"SASS {dtype}/{form}/{width}: {lp['ops']} ops for "
                  f"{lp['maxes']} maxes: the chain was folded")


def cuobjdump_sass(lib_path):
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.access(tool, os.X_OK), "cuobjdump is missing: the probe's "
          "SASS cannot be checked for a folded chain")
    return subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, timeout=300, check=True).stdout


def phase_probe(torch, vp, build):
    """The ceiling probe (tools/vpu_probe.py's kernels): each
    instantiation's chain loops in the SASS, the nine variants against
    plain, then the probe's entry points at the JAX defaults with their
    launches counted from 0, the rates beside the SM clock read under each
    one's own launch, and fill_scaling. Sets PROBE_RATES."""
    import numpy as np

    loops = sass_chain_loops(cuobjdump_sass(build.library_path()))
    emit({"phase": "probe", "sass_chain_loops": {
        "/".join(map(str, k)): v for k, v in loops.items()}})
    sass_check(loops, vp.VARIANTS, vp.OPS_PER_LINK)
    worst = 0.0
    for dtype, form, width in vp.VARIANTS:
        tdt = vp.DTYPES[dtype][0]
        for shape in (PROBE_SHAPES[width], PROBE_RAGGED):
            rng = np.random.default_rng(SEED)
            a, b = (torch.from_numpy(rng.integers(-8, 9, shape)).to(
                "cuda", tdt) for _ in range(2))
            got = vp.chain(a, b, PROBE_CHECK_CHAIN, width, form)
            torch.cuda.synchronize()
            want = vp.chain_plain(a, b, PROBE_CHECK_CHAIN, width)
            err = max_err(torch, got.float(), want.float())
            equal = bool(torch.equal(got, want))
            emit({"phase": "probe", "variant": f"{dtype}/{form}/{width}",
                  "shape": f"{shape[0]}x{shape[1]}",
                  "chain": PROBE_CHECK_CHAIN, "bit_equal": equal,
                  "max_abs_err": err, "tolerance": TOL})
            check(equal and err == 0.0, f"probe {dtype}/{form}/{width} at "
                  f"{shape}: kernel != plain")
            worst = max(worst, err)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    top_mhz = float(smi_query("clocks.max.sm"))

    # the probe path: its launches start here
    vp.reset_counts()
    rows = []

    def rate_rows(probe, results):
        for r in results:
            # the clock under this reading's own launch
            dt = vp.DTYPES[r["dtype"]][0]
            a, b = (torch.full(r["shape"], v, dtype=dt, device="cuda")
                    for v in (1, 0))
            mhz, watts = smi_under_load(torch, vp, vp.launcher(
                a, b, r["chain"], r["width"], r["form"]))
            per_clk = r["ops_per_s"] / (mhz * 1e6 * sms)
            ceiling = LANES_PER_SM_CLOCK * vp.ops_per_instruction(
                r["dtype"], r["form"])
            row = {"phase": "probe", "probe": probe,
                   "variant": f"{r['dtype']}/{r['form']}/{r['width']}",
                   "shape": f"{r['shape'][0]}x{r['shape'][1]}",
                   "chain": r["chain"], "measures": r["measures"],
                   "ms": r["seconds"] * 1e3, "tops": r["ops_per_s"] / 1e12,
                   "clocks_sm_mhz": mhz, "power_w": watts,
                   "ops_per_clk_per_sm": per_clk,
                   "issue_ceiling_ops_per_clk_per_sm": ceiling,
                   "fraction_of_peak_ops": r["ops_per_s"] / PEAK_OPS}
            emit(row)
            check(r["ops_per_s"] <= PROBE_GUARD * ceiling * top_mhz * 1e6
                  * sms, f"probe {row['variant']}: {row['tops']:.3f} T op/s "
                  f"is above {PROBE_GUARD:.0%} of the issue ceiling at "
                  f"{top_mhz} MHz: the chain was folded")
            rows.append(row)

    rate_rows("vmem_ceiling", vp.vmem_ceiling())
    rate_rows("vpu_roofline", vp.vpu_roofline())
    for dtype in ("float32", "int32", "float64"):
        shape, chain, width = PROBE_SHAPES[8], 4096, 8
        PROBE_RATES[dtype] = vp.roofline_ops_per_sec(dtype)
        ops = vp.OPS_PER_LINK * width * shape[0] * shape[1] * chain
        rate_rows("roofline_ops_per_sec", [{
            "dtype": dtype, "form": "plain", "width": width, "shape": shape,
            "chain": chain, "seconds": ops / PROBE_RATES[dtype],
            "ops_per_s": PROBE_RATES[dtype],
            "measures": "issue rate, 8 independent chains a thread"}])
    SM_MHZ["int32"] = next(
        r["clocks_sm_mhz"] for r in rows
        if r["probe"] == "roofline_ops_per_sec" and r["variant"].startswith(
            "int32/"))
    torch.cuda.synchronize()
    launches, plain = dict(vp.launches), vp.plain_calls
    emit({"phase": "probe", "launches": launches, "plain_calls": plain,
          "sms": sms, "clocks_max_sm_mhz": top_mhz,
          "rates_tops": {k: v / 1e12 for k, v in PROBE_RATES.items()}})
    for name in launches:
        check(launches[name] > 0, f"kernel {name} never launched on the "
              f"probe path")
    check(plain == 0, f"the plain version ran on the probe path: {plain}")
    for r in vp.fill_scaling():
        emit({"phase": "probe", **r})
        check(r["exact"], f"fill_scaling {r['B']}x{r['L']}: repeat runs "
              f"differ")

    # the representative timings: vmem_ceiling's float32 and the float32
    # roofline, each against one call of the plain version at its shape;
    # probe_ms is null for the roofline, whose rate it would divide by
    out = {}
    for name, probe in (("probe_chain", "vmem_ceiling"),
                        ("probe_ilp", "roofline_ops_per_sec")):
        rep = next(r for r in rows if r["probe"] == probe
                   and r["variant"].startswith("float32/"))
        width = int(rep["variant"].rsplit("/", 1)[1])
        shape = PROBE_SHAPES[width]
        a, b = (torch.full(shape, v, dtype=torch.float32, device="cuda")
                for v in (1.0, 0.0))
        _, plain_ms = timed_call(torch, lambda: vp.chain_plain(
            a, b, rep["chain"], width))
        ops = vp.OPS_PER_LINK * width * shape[0] * shape[1] * rep["chain"]
        b_ms, b_by = bound(ops, 3 * 4 * shape[0] * shape[1])
        out[name] = {**rep, "plain_ms": plain_ms, "bound_ms": b_ms,
                     "bound_by": b_by, "max_abs_err": worst,
                     "probe_ms": probe_ms(ops) if width == 1 else None}
    return launches, out


def kernel_inputs(B, m_pad, n_pad, ragged, seed, device, lengths=None,
                  sites=None):
    """Seeded kernel inputs: ragged lengths (m in [m_pad/2, m_pad], n in
    [n_pad/2, n_pad], n >= m), the (m, n) ``lengths`` of every pair, or
    full buckets; ``allow`` closed at 5% of the columns, or at ``sites``
    junction sites a target. Returns (args, true cells)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
    if lengths:
        ms, ns = np.full((B, 1), lengths[0]), np.full((B, 1), lengths[1])
    elif ragged:
        ms = rng.integers(m_pad // 2, m_pad + 1, (B, 1))
        ns = np.maximum(rng.integers(n_pad // 2, n_pad + 1, (B, 1)), ms)
    else:
        ms, ns = np.full((B, 1), m_pad), np.full((B, 1), n_pad)
    qs = rng.choice(alpha, (B, m_pad))
    ts = rng.choice(alpha, (B, n_pad))
    qs[np.arange(m_pad)[None, :] >= ms] = -1
    ts[np.arange(n_pad)[None, :] >= ns] = -2
    if sites:
        allow = np.ones((B, n_pad), np.float32)
        for k in range(B):
            allow[k, rng.integers(0, ns[k, 0], sites)] = 0.0
    else:
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


def run_variant(scan, variant, m_pad, n_pad, args, plain, c_blk=None):
    """A score fill: the plain version, the blocked kernel at column block
    ``c_blk``, or the flat kernel."""
    qs, ts, allow, ns, ms, pm = args
    if c_blk and not plain:
        from aligntools_tpu_torch.ops import blocked

        mode = variant.split("+")[0]
        return blocked.blocked_scores(mode, variant == "fit+jump", m_pad,
                                      n_pad, c_blk, qs, ts, allow, ns, ms,
                                      pm)
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


def timed_call(torch, fn):
    """(fn's result, its CUDA-event time in ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


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


def compare(torch, scan, variant, m_pad, n_pad, args, c_blk=None):
    """Kernel (the blocked one at ``c_blk``) and plain version on the same
    inputs: (bit_equal, max_abs_err)."""
    k_out = run_variant(scan, variant, m_pad, n_pad, args, False, c_blk)
    torch.cuda.synchronize()
    p_out = run_variant(scan, variant, m_pad, n_pad, args, True)
    torch.cuda.synchronize()
    return bool(torch.equal(k_out, p_out)), max_err(torch, k_out, p_out)


def score_route(scan, variant, n_pad):
    """The route scan.scores / fit_scores take for ``variant`` at n_pad:
    its label."""
    mode = variant.split("+")[0]
    c_blk = scan.blocked_c_blk(mode, n_pad)
    if c_blk:
        return f"blocked c_blk {c_blk}"
    return "flat W {1} x {0} threads".format(*scan.flat_shape(mode, n_pad))


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
            # the same fill through the blocked kernel (a record only: the
            # flat shapes keep the flat kernels)
            c_blk = min(n_pad, FLAT_AS_BLOCKED_C_BLK)
            b_equal, b_err = compare(torch, scan, variant, m_pad, n_pad, args,
                                     c_blk)
            check(b_equal and b_err == 0.0, f"blocked {variant} at {B}x("
                  f"{m_pad}x{n_pad}), c_blk {c_blk}: kernel != plain")
            ms_b = statistics.median(timed_ms(torch, lambda: run_variant(
                scan, variant, m_pad, n_pad, args, False, c_blk))
                for _ in range(2))
            b_ms, b_by = bound(
                SCORE_OPS[variant] * cells,
                input_bytes(args, variant == "fit+jump") + 4 * B)
            row = {
                "phase": "kernels", "variant": variant,
                "shape": f"{B}x{m_pad}x{n_pad}", "ragged": ragged,
                "route": score_route(scan, variant, n_pad),
                "bit_equal": equal, "max_abs_err": err, "tolerance": TOL,
                "ms": ms_k, "plain_ms": ms_p, "bound_ms": b_ms,
                "bound_by": b_by,
                "probe_ms": probe_ms(SCORE_OPS[variant] * cells,
                                     variant == "edit"),
                "true_cells": cells,
                "gcups": cells / ms_k / 1e6, "plain_gcups": cells / ms_p / 1e6,
                "blocked_ms": ms_b, "blocked_c_blk": c_blk,
            }
            emit(row)
            check(equal and err == 0.0,
                  f"{variant} at {B}x({m_pad}x{n_pad}): kernel != plain")
            results.append(row)
    phase_kernels_cap(torch, scan)
    phase_kernels_ties(torch, scan)
    return results


def phase_kernels_cap(torch, scan):
    """The score fills' route across the register-strip kernels' caps: at
    each n_pad of SCORE_CAP_N_PADS, each variant of SCORE_CAP_VARIANTS
    through the route (scan.scores / fit_scores: the flat kernel up to
    scan.flat_cap(mode) columns, past it the blocked fill at
    select.blocked_c_blk(), ragged) against plain, bit for bit, then timed
    beside the blocked fill at every column block of the sweep up to n_pad
    (ragged where it does not divide n_pad), each held to the same scores;
    warm medians of three."""
    from aligntools_tpu_torch.ops import ptr

    for n_pad in SCORE_CAP_N_PADS:
        B, m_pad = SCORE_CAP_SHAPE[n_pad <= ptr.FLAT_REG_MAX_N_PAD]
        args, cells = kernel_inputs(B, m_pad, n_pad, True, SEED + 5, "cuda")
        for variant in SCORE_CAP_VARIANTS:
            label = f"{variant} at {B}x{m_pad}x{n_pad}"
            equal, err = compare(torch, scan, variant, m_pad, n_pad, args)
            check(equal and err == 0.0, f"score fill {label}: kernel != plain")
            want = run_variant(scan, variant, m_pad, n_pad, args, False)
            route_ms = statistics.median(timed_ms(torch, lambda: run_variant(
                scan, variant, m_pad, n_pad, args, False)) for _ in range(3))
            c_blk_ms = {}
            for c_blk in C_BLK_SWEEP:
                if c_blk > n_pad:
                    continue
                got = run_variant(scan, variant, m_pad, n_pad, args, False,
                                  c_blk)
                torch.cuda.synchronize()
                check(torch.equal(got, want),
                      f"score fill {label}, c_blk {c_blk}: kernel != plain")
                c_blk_ms[c_blk] = statistics.median(timed_ms(
                    torch, lambda: run_variant(scan, variant, m_pad, n_pad,
                                               args, False, c_blk))
                    for _ in range(3))
            emit({"phase": "kernels", "cap": label,
                  "route": score_route(scan, variant, n_pad),
                  "route_ms": route_ms, "c_blk_ms": c_blk_ms,
                  "cap_now": scan.flat_cap(variant.split("+")[0]),
                  "true_cells": cells,
                  "bit_equal": equal, "max_abs_err": err, "tolerance": TOL})
        del args, want
        torch.cuda.empty_cache()


def phase_kernels_ties(torch, scan):
    """The start-info ties of tests/ptr_ties.py through each score fill of
    the register-strip kernels (global, local, overlap, fit, fit+jump,
    edit), against plain."""
    import numpy as np

    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import ptr_ties

    from aligntools_tpu_torch.convert import kernel_inputs_from_numpy

    arrs = ptr_ties.tie_inputs(SEED)
    m_pad, n_pad = ptr_ties.M_PAD, ptr_ties.N_PAD
    variants = ("global", "local", "overlap", "fit", "fit+jump", "edit")
    for variant in variants:
        mode = variant.split("+")[0]
        # edit reads the mismatch alone: a substitution cost of 1 gives the
        # pairs' edit distances
        pm = (np.array([[0, 1, 0, 0, 0, 0, 0, 0]], np.float32)
              if mode == "edit" else ptr_ties.pmat(mode))
        args = kernel_inputs_from_numpy(*arrs, pm, "cuda")
        equal, err = compare(torch, scan, variant, m_pad, n_pad, args)
        check(equal and err == 0.0,
              f"score fill on the tie inputs, {variant}: kernel != plain")
    emit({"phase": "kernels", "ties": len(variants), "cases": variants,
          "bit_equal": True, "max_abs_err": 0.0, "tolerance": TOL})


def ptr_fill(ptr, mode, jump, m_pad, n_pad, args, rpb, c_blk=None):
    """The pointer kernel: the blocked one at column block ``c_blk``, or
    the flat one."""
    qs, ts, allow, ns, ms, pm = args
    if c_blk:
        from aligntools_tpu_torch.ops import blocked

        return blocked.blocked_ptr_fill(mode, jump, m_pad, n_pad, c_blk, qs,
                                        ts, allow, ns, ms, pm, rpb)
    return ptr.ptr_fill(mode, jump, m_pad, n_pad, qs, ts, allow, ns, ms, pm,
                        rpb)


def ptr_compare(torch, ptr, tb, mode, jump, rpb, m_pad, n_pad, args,
                c_blk=None, walk=True):
    """Pointer kernel vs plain, then (``walk``) walk kernel vs plain on the
    kernel's pointers: (fill_equal, fill_err, walk_equal, walk_err, k_out,
    walk outputs, starts, the plain walk's ms)."""
    qs, ts, allow, ns, ms, pm = args
    k_out = ptr_fill(ptr, mode, jump, m_pad, n_pad, args, rpb, c_blk)
    torch.cuda.synchronize()
    p_out = ptr.ptr_fill_plain(mode, jump, m_pad, n_pad, qs, ts, allow, ns,
                               ms, pm, rpb)
    torch.cuda.synchronize()
    f_equal = all(torch.equal(k, p) for k, p in zip(k_out, p_out))
    f_err = max([max_err(torch, k, p) for k, p in zip(k_out[:3], p_out[:3])]
                + [0.0 if torch.equal(k_out[3], p_out[3]) else float("inf")])
    del p_out
    if not walk:
        return f_equal, f_err, True, 0.0, k_out, None, None, None
    starts = tb.walk_starts(mode, *k_out[:3], ms, ns)
    w_k = tb.walk(mode, rpb, k_out[3], qs, ts, starts)
    torch.cuda.synchronize()
    w_p, w_plain_ms = timed_call(
        torch, lambda: tb.walk_plain(mode, rpb, k_out[3], qs, ts, starts))
    w_equal = all(torch.equal(k, p) for k, p in zip(w_k, w_p))
    w_err = max([max_err(torch, w_k[2], w_p[2])]
                + [0.0 if torch.equal(k, p) else float("inf")
                   for k, p in zip(w_k[:2], w_p[:2])])
    return f_equal, f_err, w_equal, w_err, k_out, w_k, starts, w_plain_ms


def ptr_variants_ms(torch, ptr, mode, jump, rpb, m_pad, n_pad, args, want,
                    label):
    """The fill through the blocked kernel at each column block of
    C_BLK_SWEEP up to n_pad (``c_blk_ms``; ragged where it does not divide
    n_pad), each held bit-equal to ``want`` (the routed fill's outputs,
    equal to plain) and timed (warm median of three)."""
    out = {"c_blk_ms": {}}
    for c_blk in C_BLK_SWEEP:
        if c_blk > n_pad:
            continue

        def fn(c_blk=c_blk):
            return ptr_fill(ptr, mode, jump, m_pad, n_pad, args, rpb, c_blk)

        got = fn()
        torch.cuda.synchronize()
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"pointer fill {label}, c_blk {c_blk}: kernel != plain")
        del got
        out["c_blk_ms"][c_blk] = statistics.median(timed_ms(torch, fn)
                                                   for _ in range(3))
    return out


def ptr_route(ptr, n_pad, dtype=None):
    """The routed pointer fill of a rows bucket (ptr.ptr_fill; ``dtype``
    float64: the double instances'): its column block (None: the flat
    kernel) and a label."""
    import torch

    dtype = dtype or torch.float32
    c_blk = ptr.blocked_c_blk(n_pad, dtype)
    if c_blk:
        return c_blk, f"blocked c_blk {c_blk}"
    threads, w = ptr.launch_shape(n_pad, dtype)
    return None, f"flat W {w} x {threads} threads"


def r1_bucket(torch):
    """The largest bucket (B * m_pad * n_pad) of the 20,000-pair local rows
    run (the slice phase's R1): its kernel inputs and true cells."""
    from aligntools_tpu_torch import batch
    from aligntools_tpu_torch.convert import params_matrix
    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.utils.synth import clustered_pairs

    b = max(main_path_buckets(clustered_pairs(20000, seed=SEED), None),
            key=lambda b: len(b.idx) * b.m_pad * b.n_pad)
    qs, ts, allow, ns, ms = batch._bucket_tensors(b, torch.device("cuda"))
    args = (qs, ts, allow, ns, ms, params_matrix(AlignParams(), "cuda"))
    return len(b.idx), b.m_pad, b.n_pad, args, int((b.m * b.n).sum())


def phase_ptr(torch, ptr, tb):
    """Each pointer-fill row through the rows path's route (flat kernel,
    or the blocked one past ptr.FLAT_REG_MAX_N_PAD) against plain, then
    the walk on its pointers; every column block of the sweep held to the
    same bytes and timed; then the cap sweep and the tie inputs of
    tests/ptr_ties.py."""
    from aligntools_tpu_torch import layout
    from aligntools_tpu_torch.ops import _build

    # the pointer fill's instances, the score instances (PTRS false) and
    # the edit score fill
    emit({"phase": "ptr", "resource_usage": resource_usage(
        _build.library_path(), ("ptr_affine_kernel", "ptr_overlap_kernel",
                                "edit_score_kernel"))})
    fills, walks = [], []
    shapes = [(B, m_pad, n_pad, cases,
               kernel_inputs(B, m_pad, n_pad, ragged, SEED, "cuda"))
              for B, m_pad, n_pad, ragged, cases in PTR_SHAPES]
    B, m_pad, n_pad, args, cells = r1_bucket(torch)
    rpb = layout.rows_per_byte("local", False, m_pad)
    shapes.append((B, m_pad, n_pad, (("local", False, rpb),), (args, cells)))
    n_wide = ptr.FLAT_REG_MAX_N_PAD + PTR_WIDE_EXTRA
    check(all(n_wide % c for c in C_BLK_SWEEP), f"n_pad {n_wide} is not "
          f"ragged at every column block")
    shapes.append((PTR_WIDE[0], PTR_WIDE[1], n_wide, (("local", False, 2),),
                   kernel_inputs(PTR_WIDE[0], PTR_WIDE[1], n_wide, True, SEED,
                                 "cuda")))
    del args
    for B, m_pad, n_pad, cases, (args, cells) in shapes:
        qs, ts, allow, ns, ms, pm = args
        for mode, jump, rpb in cases:
            c_route, route = ptr_route(ptr, n_pad)
            variant = mode + ("+jump" if jump else "")
            shape = f"{B}x{m_pad}x{n_pad}"
            f_eq, f_err, w_eq, w_err, k_out, w_k, starts, w_plain = (
                ptr_compare(torch, ptr, tb, mode, jump, rpb, m_pad, n_pad,
                            args, c_route))
            check(f_eq and f_err == 0.0,
                  f"pointer fill {variant} rpb {rpb} at {shape} ({route}): "
                  f"kernel != plain")

            def fill():
                return ptr_fill(ptr, mode, jump, m_pad, n_pad, args, rpb,
                                c_route)

            fill_plain = (lambda: ptr.ptr_fill_plain(
                mode, jump, m_pad, n_pad, qs, ts, allow, ns, ms, pm, rpb))
            ms_k, ms_p = turns(torch, fill, fill_plain, rounds=1)
            sweep = ptr_variants_ms(torch, ptr, mode, jump, rpb, m_pad,
                                    n_pad, args, k_out,
                                    f"{variant} rpb {rpb} at {shape}")
            ptr_bytes = k_out[3].numel()
            ops = (SCORE_OPS[variant] + PTR_EXTRA_OPS[variant]) * cells
            b_ms, b_by = bound(ops, input_bytes(args, jump) + ptr_bytes
                               + 12 * B)
            row = {"phase": "ptr", "variant": f"{variant}/rpb{rpb}",
                   "shape": shape, "route": route, "bit_equal": f_eq,
                   "max_abs_err": f_err, "tolerance": TOL, "ms": ms_k,
                   "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                   "probe_ms": probe_ms(ops), "true_cells": cells,
                   "ptr_bytes": ptr_bytes, "gcups": cells / ms_k / 1e6,
                   # the same fill at c_blk min(n_pad, 8,192), as before
                   "blocked_ms": sweep["c_blk_ms"].get(
                       min(n_pad, FLAT_AS_BLOCKED_C_BLK)),
                   **sweep}
            emit(row)
            fills.append(row)
            walks.append(walk_row(torch, tb, mode, rpb, variant, shape,
                                  k_out[3], qs, ts, starts, w_k, w_eq, w_err,
                                  w_plain))
            del k_out, w_k
        del args, qs, ts, allow, ns, ms, pm
        torch.cuda.empty_cache()
    phase_ptr_cap(torch, ptr)
    phase_ptr_ties(torch, ptr)
    return fills, walks


def phase_ptr_cap(torch, ptr):
    """The flat kernel against the blocked one past 4,096 columns, where
    FLAT_REG_MAX_N_PAD is chosen: each n_pad of PTR_CAP_N_PADS at the flat
    kernel's own shape and at every column block of the sweep, all held to
    the same bytes, warm medians of three."""
    for B, m_pad, mode, jump, rpb in PTR_CAP_CASES:
        for n_pad in PTR_CAP_N_PADS:
            args, cells = kernel_inputs(B, m_pad, n_pad, True, SEED + 5,
                                        "cuda")
            label = f"{mode}{'+jump' if jump else ''} rpb {rpb} at {B}x{m_pad}x{n_pad}"
            want = ptr_fill(ptr, mode, jump, m_pad, n_pad, args, rpb)
            flat = statistics.median(timed_ms(torch, lambda: ptr_fill(
                ptr, mode, jump, m_pad, n_pad, args, rpb)) for _ in range(3))
            sweep = ptr_variants_ms(torch, ptr, mode, jump, rpb, m_pad,
                                    n_pad, args, want, label)
            emit({"phase": "ptr", "cap": label, "flat_ms": flat,
                  "flat_shape": list(ptr.launch_shape(n_pad)),
                  "cap_now": ptr.FLAT_REG_MAX_N_PAD, "true_cells": cells,
                  **sweep})
            del args, want
    torch.cuda.empty_cache()


def phase_ptr_ties(torch, ptr):
    """The start-info ties of tests/ptr_ties.py: every (mode, rpb) layout
    of P1, against plain."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import ptr_ties

    from aligntools_tpu_torch.convert import kernel_inputs_from_numpy

    arrs = ptr_ties.tie_inputs(SEED)
    m_pad, n_pad = ptr_ties.M_PAD, ptr_ties.N_PAD
    checked = []
    for mode, jump, rpb in PTR_SHAPES[0][4]:
        args = kernel_inputs_from_numpy(*arrs, ptr_ties.pmat(mode), "cuda")
        want = ptr.ptr_fill_plain(mode, jump, m_pad, n_pad, *args, rpb)
        got = ptr.ptr_fill(mode, jump, m_pad, n_pad, *args, rpb)
        torch.cuda.synchronize()
        label = f"{mode}{'+jump' if jump else ''}/rpb{rpb}"
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"pointer fill on the tie inputs, {label}: kernel != plain")
        checked.append(label)
    emit({"phase": "ptr", "ties": len(checked), "cases": checked,
          "bit_equal": True, "max_abs_err": 0.0, "tolerance": TOL})


def resource_usage(lib_path, kernels):
    """Registers and local-memory (spill) bytes a thread of each kernel
    instance whose name holds one of ``kernels``, from cuobjdump
    --dump-resource-usage."""
    import re
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    check(os.access(tool, os.X_OK), "cuobjdump is missing")
    text = subprocess.run([tool, "--dump-resource-usage", lib_path],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout
    filt = shutil.which("cu++filt") or "/usr/local/cuda/bin/cu++filt"
    out, name = [], None
    for line in text.splitlines():
        hit = re.search(r"Function (\S+):", line)
        if hit:
            name = hit.group(1)
            continue
        if name is None or "REG:" not in line:
            continue
        if any(k in name for k in kernels):
            use = dict(re.findall(r"(\w+):(\d+)", line))
            if os.access(filt, os.X_OK):
                name = subprocess.run([filt, name], capture_output=True,
                                      text=True, timeout=60).stdout.strip()
            out.append({"kernel": name, "registers": int(use["REG"]),
                        "local_bytes": int(use.get("LOCAL", -1)),
                        "stack_bytes": int(use.get("STACK", -1))})
        name = None
    check(out, f"cuobjdump listed no kernel of {kernels}")
    return out


def walk_row(torch, tb, mode, rpb, variant, shape, ptrs, qs, ts, starts,
             w_k, w_eq, w_err, plain_ms, band=None):
    """Time the walk kernel (warm median of two; the plain version's time
    is its one comparison call's) and check it against plain. ``band``: a
    window walk over banded pointers."""
    tb.walk(mode, rpb, ptrs, qs, ts, starts, band)
    ms_k = statistics.median(
        timed_ms(torch, lambda: tb.walk(mode, rpb, ptrs, qs, ts, starts,
                                        band))
        for _ in range(2))
    ms_launch = launch_ms(torch, tb, mode, rpb, ptrs, qs, ts, starts, band)
    steps = int(w_k[2][0].sum())
    longest = int(w_k[2][0].max())
    B = qs.shape[0]
    b_ms, b_by = bound(WALK_OPS_PER_STEP * steps,
                       WALK_BYTES_PER_STEP * steps + 28 * B)
    row = {"phase": "walk", "variant": f"{variant}/rpb{rpb}",
           "shape": shape, "bit_equal": w_eq, "max_abs_err": w_err,
           "tolerance": TOL, "ms": ms_k, "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by,
           "probe_ms": probe_ms(WALK_OPS_PER_STEP * steps, True),
           "kernel_ms": ms_launch, "chain_ms": chain_ms(longest),
           "steps": steps,
           "longest_walk": longest}
    emit(row)
    check(w_eq and w_err == 0.0,
          f"walk {variant} rpb {rpb} at {shape}: kernel != plain")
    return row


def launch_ms(torch, tb, mode, rpb, ptrs, qs, ts, starts, band,
              launches=5):
    """The walk kernel alone: ``launches`` launches on outputs made once
    (the wrapper's checks and zero fills left out), back to back between
    two events, a launch's share of the median of three."""
    B, m_pad = qs.shape
    n_pad = ts.shape[1]
    c1 = torch.zeros((m_pad + n_pad + 1, B), dtype=torch.uint8,
                     device="cuda")
    c2 = torch.zeros_like(c1)
    sc = torch.empty((4, B), dtype=torch.int32, device="cuda")
    fn, stream = tb._kernel(), torch.cuda.current_stream().cuda_stream
    args = (tb.MODES.index(mode), rpb, ptrs.data_ptr(), qs.data_ptr(),
            ts.data_ptr(), starts.data_ptr(), c1.data_ptr(), c2.data_ptr(),
            sc.data_ptr(), B, m_pad, n_pad, ptrs.shape[1], ptrs.shape[2],
            -1 if band is None else band, tb.TILE_COLS, 0, stream)

    def run():
        for _ in range(launches):
            check(fn(*args) == 0, "walk kernel launch failed")

    run()
    return statistics.median(timed_ms(torch, run) for _ in range(3)) / launches


def chain_ms(longest_walk):
    """The walk's chain bound (WALK_CHAIN_CYCLES) in ms."""
    return longest_walk * WALK_CHAIN_CYCLES / (SM_MHZ["int32"] * 1e3)


def phase_walk_cases(torch, tb):
    """The walk kernel against plain on the walks of tests/walk_cases.py,
    drawn to cross its tiles: columns and all four scalars."""
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    import walk_cases

    names, steps = [], 0
    for c in walk_cases.flat_cases() + walk_cases.window_cases():
        args = [torch.from_numpy(x).cuda() for x in (c.ptrs, c.qs, c.ts,
                                                     c.starts)]
        got = tb.walk(c.mode, c.rpb, *args, c.band)
        torch.cuda.synchronize()
        want = tb.walk_plain(c.mode, c.rpb, *args, c.band)
        label = f"{c.name}/{c.mode}/rpb{c.rpb}"
        check(all(torch.equal(g, w) for g, w in zip(got, want)),
              f"walk on drawn case {label}: kernel != plain")
        names.append(label)
        steps += int(want[2][0].sum())
    emit({"phase": "walk", "drawn_cases": len(names), "cases": names,
          "steps": steps, "bit_equal": True, "max_abs_err": 0.0,
          "tolerance": TOL})


def blocked_check(torch, label, kernel_at, plain, c_blks):
    """The blocked kernel at each column block of ``c_blks`` against one
    call of the plain version; returns the largest error (scores, start
    info; pointer bytes are compared for equality)."""
    want = plain()
    torch.cuda.synchronize()
    want = want if isinstance(want, tuple) else (want,)
    worst = 0.0
    for c_blk in c_blks:
        got = kernel_at(c_blk)
        torch.cuda.synchronize()
        got = got if isinstance(got, tuple) else (got,)
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(max_err(torch, g, w) if g.dtype != torch.uint8
                  else 0.0 if torch.equal(g, w) else float("inf")
                  for g, w in zip(got, want))
        check(equal and err == 0.0, f"{label}, c_blk {c_blk}: kernel != "
              f"plain")
        worst = max(worst, err)
        del got
    return worst


def phase_blocked(torch, scan, ptr):
    """The column-blocked kernels against their plain versions at every
    column block of C_BLK_SWEEP: L1, timed at the kernels' own column
    block; L2 and B1 at the reference fixture's shape, each timed at every
    column block. (The walk on blocked pointers is held against its plain
    version on an L3 bucket.)"""
    from aligntools_tpu_torch.engine import select

    rows = []
    B, m_pad, n_pad = BLOCKED_L1
    args, cells = kernel_inputs(B, m_pad, n_pad, True, SEED + 1, "cuda",
                                sites=3)
    qs, ts, allow, ns, ms, pm = args
    shape = f"{B}x{m_pad}x{n_pad}"
    for variant in ("global", "local", "overlap", "edit", "fit", "fit+jump"):
        def kernel(c_blk=select.blocked_c_blk()):
            return run_variant(scan, variant, m_pad, n_pad, args, False,
                               c_blk)

        def plain():
            return run_variant(scan, variant, m_pad, n_pad, args, True)

        err = blocked_check(torch, f"blocked scores {variant} at {shape}",
                            kernel, plain, C_BLK_SWEEP)
        ms_k, ms_p = turns(torch, kernel, plain)
        rows.append(blocked_row("blocked_scores", "L1", variant, shape,
                                cells, ms_k, ms_p, args, 4 * B, err))
    for mode, jump, rpb in PTR_SHAPES[0][4]:
        variant = mode + ("+jump" if jump else "")

        def kernel(c_blk=select.blocked_c_blk()):
            return ptr_fill(ptr, mode, jump, m_pad, n_pad, args, rpb, c_blk)

        def plain():
            return ptr.ptr_fill_plain(mode, jump, m_pad, n_pad, qs, ts, allow,
                                      ns, ms, pm, rpb)

        err = blocked_check(torch, f"blocked pointer fill {variant} rpb "
                            f"{rpb} at {shape}", kernel, plain, C_BLK_SWEEP)
        ms_k, ms_p = turns(torch, kernel, plain, rounds=1)
        rows.append(blocked_row("blocked_ptr", "L1", f"{variant}/rpb{rpb}",
                                shape, cells, ms_k, ms_p, args,
                                12 * B + B * m_pad * n_pad // rpb, err))
    del args, qs, ts, allow, ns, ms, pm
    # L2 and B1: fit+jump at the fixture's shape, the score and the pointer
    # fill at every column block of the sweep
    for level, (B, m_pad, n_pad, m, n) in (("L2", BLOCKED_L2),
                                           ("B1", BLOCKED_B1)):
        args, cells = kernel_inputs(B, m_pad, n_pad, False, SEED + 2, "cuda",
                                    lengths=(m, n), sites=3)
        qs, ts, allow, ns, ms, pm = args
        shape = f"{B}x{m_pad}x{n_pad}"

        def kernel(c_blk=select.blocked_c_blk()):
            return run_variant(scan, "fit+jump", m_pad, n_pad, args, False,
                               c_blk)

        def plain():
            return run_variant(scan, "fit+jump", m_pad, n_pad, args, True)

        rows += blocked_sweep(torch, "blocked_scores", level, "fit+jump",
                              shape, cells, args, 4 * B, kernel, plain)

        def kernel(c_blk=select.blocked_c_blk()):
            return ptr_fill(ptr, "fit", True, m_pad, n_pad, args, 1, c_blk)

        def plain():
            return ptr.ptr_fill_plain("fit", True, m_pad, n_pad, qs, ts, allow,
                                      ns, ms, pm, 1)

        rows += blocked_sweep(torch, "blocked_ptr", level, "fit+jump/rpb1",
                              shape, cells, args, 12 * B + B * m_pad * n_pad,
                              kernel, plain)
        del args, qs, ts, allow, ns, ms, pm
        torch.cuda.empty_cache()
    return rows


def blocked_sweep(torch, kernel_name, level, variant, shape, cells, args,
                  out_bytes, kernel, plain):
    """The blocked kernel at every column block of C_BLK_SWEEP held against
    one plain call, then timed at each (warm median of three); the plain
    version timed in turns beside the kernels' own column block."""
    from aligntools_tpu_torch.ops import blocked

    err = blocked_check(torch, f"{kernel_name} {variant} at {shape}", kernel,
                        plain, C_BLK_SWEEP)
    torch.cuda.empty_cache()
    _, ms_p = turns(torch, kernel, plain, rounds=1)
    out = []
    for c_blk in C_BLK_SWEEP:
        kernel(c_blk)
        ms_k = statistics.median(timed_ms(torch, lambda: kernel(c_blk))
                                 for _ in range(3))
        out.append(blocked_row(kernel_name, level, variant, shape, cells,
                               ms_k, ms_p, args, out_bytes, err, c_blk))
    return out


def blocked_row(kernel, level, variant, shape, cells, ms_k, ms_p, args,
                out_bytes, err=0.0, c_blk=None):
    """One blocked-kernel timing line (at column block ``c_blk``, by
    default the routes' own), with its bound."""
    from aligntools_tpu_torch.engine import select

    ops = (SCORE_OPS[variant.split("/")[0]]
           + (PTR_EXTRA_OPS[variant.split("/")[0]]
              if kernel == "blocked_ptr" else 0)) * cells
    b_ms, b_by = bound(ops, input_bytes(args, "jump" in variant) + out_bytes)
    row = {"phase": "blocked", "kernel": kernel, "level": level,
           "variant": variant, "shape": shape,
           "c_blk": c_blk or select.blocked_c_blk(), "bit_equal": err == 0.0,
           "max_abs_err": err, "tolerance": TOL, "ms": ms_k, "plain_ms": ms_p,
           "bound_ms": b_ms, "bound_by": b_by,
           "probe_ms": probe_ms(ops, variant == "edit"), "true_cells": cells,
           "gcups": cells / ms_k / 1e6}
    emit(row)
    return row


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


def sample(pool, k):
    """k seeded picks from ``pool``, in order."""
    return sorted(random.Random(SEED).sample(list(pool), k))


def rows_match_scores(tag, rows_tsv, scores_tsv, pairs):
    """The rows TSV's names and score column equal the scores TSV's, a
    line a pair; returns the rows TSV's lines."""
    rows, scores = read_lines(rows_tsv), read_lines(scores_tsv)
    check(len(rows) == len(scores) == len(pairs),
          f"{tag}: {len(rows)} rows lines, {len(scores)} score lines "
          f"for {len(pairs)} pairs")
    for k, (r, sc) in enumerate(zip(rows, scores)):
        check(r.split("\t")[:3] == sc.split("\t"),
              f"{tag}: line {k}: rows and scores runs disagree")
    return rows


def start_cpu_checks(work, runs):
    """For each run (tag, mode, rows TSV, scores TSV, pairs, sites, groups
    of sampled pair indices[, more CLI arguments]): check that the rows
    TSV's names and score column equal the scores TSV's, and start the
    port's `batch --device cpu` run on each group's pairs, one process of
    one thread a group, so that the checks on the card go on beside them.
    Returns the jobs for finish_cpu_checks."""
    jobs = []
    env = dict(os.environ, OMP_NUM_THREADS="1")
    try:
        for tag, mode, rows_tsv, scores_tsv, pairs, sites, groups, *more in (
                runs):
            rows = rows_match_scores(tag, rows_tsv, scores_tsv, pairs)
            for g, picks in enumerate(groups):
                name = f"{tag}-sample{g}"
                fasta = os.path.join(work, f"{name}.fa")
                write_fasta(fasta, [pairs[k] for k in picks],
                            [sites[k] for k in picks] if sites else None,
                            names=picks)
                out = os.path.join(work, f"{name}.cpu.tsv")
                cmd = [sys.executable, "-m", "aligntools_tpu_torch", "batch",
                       mode, fasta, *(["-s"] if sites else []),
                       *(more[0] if more else []), "--device", "cpu", "--out",
                       out]
                jobs.append((tag, rows, picks, out, cmd, subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
                    stderr=subprocess.PIPE, text=True)))
    except BaseException:
        stop_cpu_checks(jobs)
        raise
    return jobs


def stop_cpu_checks(jobs):
    for *_, p in jobs:
        if p.poll() is None:
            p.kill()
            p.wait()


def finish_cpu_checks(jobs):
    """Wait for the CPU runs and hold every sampled line of the card's rows
    TSV equal to theirs. Returns {tag: lines checked}."""
    checked = {}
    try:
        for tag, rows, picks, out, cmd, p in jobs:
            err = p.communicate(timeout=900)[1]
            check(p.returncode == 0,
                  f"{' '.join(cmd)} exited {p.returncode}: {err}")
            lines = read_lines(out)
            check(len(lines) == len(picks), f"{tag}: {len(lines)} CPU lines "
                  f"for {len(picks)} pairs")
            for k, line in zip(picks, lines):
                check(rows[k] == line,
                      f"{tag}: pair {k}: card and CPU rows differ")
            checked[tag] = checked.get(tag, 0) + len(picks)
    finally:
        stop_cpu_checks(jobs)
    return checked


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
                  rows, long_walks=None, walk_every=1, check_every=1):
    """Kernel vs plain on every ``check_every``-th bucket the main path
    builds for ``pairs`` (and on the blocked bucket of the narrowest
    target where ``long_walks`` is given), at the bucket's own B: the score
    kernel, or (``rows``) the pointer kernel and the walk. Walks over long
    targets take the plain version ~0.65 ms a step, up to the target's
    length: on blocked buckets the walk is held against it only when
    ``long_walks`` is a list, on that narrowest bucket, whose walk row is
    appended there; on flat buckets, on every ``walk_every``-th bucket
    checked."""
    from aligntools_tpu_torch import batch, layout
    from aligntools_tpu_torch.convert import params_matrix

    pm = params_matrix(params, "cuda")
    mode, jump = variant.split("+")[0], variant.endswith("+jump")
    shapes, worst, walks = [], 0.0, 0
    buckets = main_path_buckets(pairs, sites)
    blocked_buckets = [b for b in buckets
                       if b.n_pad > batch.PALLAS_FLAT_MAX_N_PAD]
    walk_long = (min(blocked_buckets,
                     key=lambda b: (b.n_pad, b.m_pad, len(b.idx)))
                 if rows and long_walks is not None and blocked_buckets
                 else None)
    picked = [b for k, b in enumerate(buckets)
              if k % check_every == 0 or b is walk_long]
    for k, b in enumerate(picked):
        qs, ts, allow, ns, ms = batch._bucket_tensors(b, torch.device("cuda"))
        shape = f"{len(b.idx)}x{b.m_pad}x{b.n_pad}"
        long = b.n_pad > batch.PALLAS_FLAT_MAX_N_PAD
        if rows:
            c_blk = ptr.blocked_c_blk(b.n_pad)  # the rows path's route
            rpb = layout.rows_per_byte(mode, jump, b.m_pad)
            walk = b is walk_long if long else k % walk_every == 0
            walks += walk
            f_eq, f_err, w_eq, w_err, k_out, w_k, starts, w_plain = (
                ptr_compare(torch, ptr, tb, mode, jump, rpb, b.m_pad,
                            b.n_pad, (qs, ts, allow, ns, ms, pm), c_blk,
                            walk))
            if b is walk_long:
                long_walks.append(walk_row(
                    torch, tb, mode, rpb, variant, f"{shape}/blocked",
                    k_out[3], qs, ts, starts, w_k, w_eq, w_err, w_plain))
            del k_out, w_k
            equal, err = f_eq and w_eq, max(f_err, w_err)
            shape += f"/rpb{rpb}"
        else:
            # through the scores path's route (scan.scores / fit_scores)
            c_blk = scan.blocked_c_blk(mode, b.n_pad)
            equal, err = compare(torch, scan, variant, b.m_pad, b.n_pad,
                                 (qs, ts, allow, ns, ms, pm))
        check(equal and err == 0.0,
              f"{variant} on main-path bucket {shape}: kernel != plain"
              + (" (pointer fill or walk)" if rows else ""))
        shapes.append(shape + (f"/blocked{c_blk}" if c_blk else ""))
        worst = max(worst, err)
        del qs, ts, allow, ns, ms
    torch.cuda.empty_cache()
    row = {"phase": "buckets", "path": "rows" if rows else "scores",
           "variant": variant, "buckets": len(shapes),
           "buckets_built": len(buckets), "shapes": shapes,
           **({"walks_checked": walks} if rows else {}),
           "bit_equal": True, "max_abs_err": worst, "tolerance": TOL}
    emit(row)
    return row


def counts(scan, ptr, tb):
    from aligntools_tpu_torch.ops import banded, blocked

    return ({**scan.launches, "ptr": ptr.launches, "walk": tb.launches,
             "walk_pause": tb.pause_launches, **blocked.launches,
             "banded": banded.launches, "banded_cta": banded.launches_cta,
             "banded_chunked": banded.launches_chunked,
             "ptr64": ptr.launches64, "edit64": scan.launches64},
            {"scan": scan.plain_calls, "ptr": ptr.plain_calls,
             "walk": tb.plain_calls, "blocked": blocked.plain_calls,
             "banded": banded.plain_calls})


def check_no_double(launches, where):
    """No double instance launched on a float32 path."""
    double = {k: v for k, v in launches.items() if k.endswith("64") and v}
    check(not double, f"double instances launched on {where}: {double}")


def reset_counts(scan, ptr, tb):
    from aligntools_tpu_torch.ops import banded, blocked

    scan.reset_counts()
    ptr.reset_counts()
    tb.reset_counts()
    blocked.reset_counts()
    banded.reset_counts()


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
    check_no_double(score_launches, "the score path")

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
    check_no_double(rows_launches, "the rows path")

    with open(cold, "rb") as a, open(rows_tsv["local"], "rb") as b:
        check(a.read() == b.read(), "local: cold and warm rows TSVs differ")
    traced_run(cli, small_fa, rows_tsv["global"], work)
    if trace_path:
        phase_profile(torch, cli, ["batch", "local", big], work, trace_path)

    # the CPU runs of the sampled pairs go on beside the bucket checks
    jobs = start_cpu_checks(work, [
        (mode, mode, tsv, scores_tsv[mode], runs_in[mode][1],
         runs_in[mode][3], [sample(range(len(runs_in[mode][1])), SAMPLES)])
        for mode, tsv in rows_tsv.items()])
    try:
        every = SLICE_CHECK_EVERY
        checked_buckets = [phase_buckets(torch, scan, ptr, tb, "local",
                                         pairs, None, params, False,
                                         check_every=every)]
        for variant in ("global", "overlap", "edit", "fit+jump"):
            checked_buckets.append(phase_buckets(
                torch, scan, ptr, tb, variant, small,
                sites if variant == "fit+jump" else None, params, False,
                check_every=every))
        checked_buckets.append(phase_buckets(torch, scan, ptr, tb, "local",
                                             pairs, None, params, True,
                                             check_every=every))
        # the walk on every SMALL_WALK_EVERY-th bucket of the 2,000-pair
        # runs, whose walks cross the whole target (the plain walk ~1 ms a
        # step on the card): the cut that pays for the banded phase
        for variant in ("global", "overlap", "fit+jump"):
            checked_buckets.append(phase_buckets(
                torch, scan, ptr, tb, variant, small,
                sites if variant == "fit+jump" else None, params, True,
                walk_every=SMALL_WALK_EVERY // every, check_every=every))
        checked = finish_cpu_checks(jobs)
    finally:
        stop_cpu_checks(jobs)
    emit({"phase": "slice", "rows_equal_scores": sorted(rows_tsv),
          "cpu_checked": checked})
    launches = {**{k: score_launches[k] for k in scan.launches},
                "ptr": rows_launches["ptr"], "walk": rows_launches["walk"]}
    return launches, checked_buckets, {"fasta": small_fa,
                                       "scores": scores_tsv,
                                       "rows": rows_tsv}


def traced_run(cli, fasta, want_tsv, work):
    """S2's `batch global` rows run once more, untraced, then twice with
    `--trace DIR` (the first traced run of the process starts the
    profiler's CUDA tracing): the Chrome trace parses and holds kernel
    events of the pointer fill and of the walk, and every TSV equals
    ``want_tsv``; the wall and the pipeline's report of each."""
    from aligntools_tpu_torch.utils.profiling import trace_file

    runs = ("untraced", "traced", "traced-again")
    tsvs = [os.path.join(work, f"global-rows-{k}.tsv") for k in runs]
    walls, reports = [], []
    for k, tsv in zip(runs, tsvs):
        trace_dir = os.path.join(work, f"trace-{k}")
        wall, report = run_cli(cli, ["batch", "global", fasta, "--out", tsv,
                                     *(["--trace", trace_dir] if k != runs[0]
                                       else [])])
        walls.append(wall)
        reports.append(report.splitlines()[-1])
    path = trace_file(trace_dir)
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    kernels = [ev.get("name", "") for ev in events
               if ev.get("cat") == "kernel"]
    fills = sum(any(k in n for k in PROFILE_GROUPS[0][1]) for n in kernels)
    walks = sum("walk_kernel" in n for n in kernels)
    with open(want_tsv, "rb") as f:
        want = f.read()
    same = []
    for tsv in tsvs:
        with open(tsv, "rb") as f:
            same.append(f.read() == want)
    emit({"phase": "slice", "run": "trace", "path": "rows", "mode": "global",
          "untraced_s": walls[0], "traced_s": walls[1:],
          "trace_overhead": [w / walls[0] - 1 for w in walls[1:]],
          "trace_bytes": os.path.getsize(path), "events": len(events),
          "kernel_events": len(kernels), "fill_kernels": fills,
          "walk_kernels": walks, "tsv_equal": same, "counters": reports})
    check(fills > 0 and walks > 0, f"--trace: {fills} pointer fill and "
          f"{walks} walk kernel events in {path}")
    check(all(same), f"--trace: the TSVs differ from the rows run's: {same}")


# the single phase: the per-mode CLI and api.align_pair on the card, each
# stdout held against ALIGNTOOLS_DEVICE=cpu; the CPU tests' test/*.fa
# invocations, one SINGLE_N x SINGLE_N pair a mode, the B1 shape (fit -s,
# the blocked pointer fill) and an edit pair past its score fill's cap (the
# blocked score fill)
SINGLE_FIXTURES = [
    ("global", "test_global.fa"),
    ("global", "-m", "1", "-u", "-1", "-o", "-4", "-e", "-1",
     "test_global.fa"),
    ("local", "test_local.fa"),
    ("local", "-m", "2", "-u", "-2", "-o", "-5", "-e", "-2", "test_local.fa"),
    ("edit", "test_edit.fa"),
    ("edit", "-u", "1", "test_edit.fa"),
    ("overlap", "test_global.fa"),
    ("overlap", "test_overlap.fa"),
    ("overlap", "-m", "3", "test_overlap.fa"),
    ("fit", "test_fit.fa"),
    ("fit", "-s", "test_fit.fa"),
    ("fit", "-m", "2", "-u", "-2", "-s", "test_fit.fa"),
]
SINGLE_MODES = ("global", "local", "fit", "overlap", "edit")
SINGLE_N = 2048
SINGLE_LONG = {"fit-B1": ("fit", 1327, 114491, True),
               "edit-long": ("edit", 2048, 20480, False)}
SINGLE_REPS = 5
SINGLE_LONG_REPS = 3
COLD_REPS = 1
COLD_ARGV = ("global", "test/test_global.fa")
# a fresh interpreter's cold start, split: import torch, the kernels'
# library load (already built), the first CUDA call (the context), then
# the command itself in-process
COLD_SPLIT = """
import contextlib, io, json, sys, time
t0 = time.perf_counter()
import torch
t1 = time.perf_counter()
from aligntools_tpu_torch.ops import _build
_build.load()
t2 = time.perf_counter()
torch.zeros(1, device="cuda")
torch.cuda.synchronize()
t3 = time.perf_counter()
from aligntools_tpu_torch import cli
with contextlib.redirect_stdout(io.StringIO()), \\
        contextlib.redirect_stderr(io.StringIO()):
    rc = cli.main(sys.argv[1:])
t4 = time.perf_counter()
print(json.dumps({"rc": rc, "import_torch_s": t1 - t0,
                  "library_load_s": t2 - t1, "first_cuda_call_s": t3 - t2,
                  "command_s": t4 - t3}))
"""


def drawn_pair(m, n, seed, sites=False):
    """A seeded random ACGT pair drawn as long_pairs draws its pairs, with
    three junction sites in [0, n) when ``sites``."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    q = alpha[rng.integers(0, 4, m)].tobytes()
    t = alpha[rng.integers(0, 4, n)].tobytes()
    return q, t, (sorted(int(x) for x in rng.integers(0, n, 3))
                  if sites else None)


def run_single(cli, argv, device):
    """The per-mode command through cli.main in-process, on the card
    (ALIGNTOOLS_DEVICE unset) or ``device``; returns (stdout, wall s)."""
    out, err = io.StringIO(), io.StringIO()
    old = os.environ.pop("ALIGNTOOLS_DEVICE", None)
    if device:
        os.environ["ALIGNTOOLS_DEVICE"] = device
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(list(argv))
    finally:
        os.environ.pop("ALIGNTOOLS_DEVICE", None)
        if old is not None:
            os.environ["ALIGNTOOLS_DEVICE"] = old
    wall = time.perf_counter() - t0
    check(rc == 0, f"{' '.join(argv)} ({device or 'card'}) exited {rc}: "
          f"{err.getvalue()}")
    return out.getvalue(), wall


def timed_runs(cmd, reps, env=None):
    """``cmd`` in a fresh process ``reps`` times; (stdout of the last, the
    walls)."""
    walls, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=300)
        walls.append(time.perf_counter() - t0)
        check(r.returncode == 0, f"{' '.join(cmd)} exited {r.returncode}: "
              f"{r.stderr}")
        out = r.stdout
    return out, walls


def native_anchor(card_out):
    """The native C++ CLI (``native_cli``, the repo's same-run baseline) on
    COLD_ARGV, timed in COLD_REPS fresh processes; or why it could not
    run."""
    binary = native_cli()
    try:
        out, walls = timed_runs([binary, *COLD_ARGV], COLD_REPS)
    except (RuntimeError, OSError, subprocess.SubprocessError) as err:
        return {"native": None, "why": f"the binary failed: {err}"}
    return {"native_s": statistics.median(walls), "native_walls_s": walls,
            "native_stdout_equal": out == card_out}


def start_single_cpu_checks(work, runs):
    """Each (label, argv) as `python3 -m aligntools_tpu_torch` with
    ALIGNTOOLS_DEVICE=cpu, one process of one thread each, its stdout to a
    file; returns the jobs for finish_single_cpu_checks."""
    env = dict(os.environ, OMP_NUM_THREADS="1", ALIGNTOOLS_DEVICE="cpu")
    jobs = []
    try:
        for label, argv in runs:
            path = os.path.join(work, f"single-{label}.cpu.out")
            with open(path, "w") as f:
                cmd = [sys.executable, "-m", "aligntools_tpu_torch", *argv]
                jobs.append((label, path, cmd, subprocess.Popen(
                    cmd, cwd=ROOT, env=env, stdout=f,
                    stderr=subprocess.PIPE, text=True)))
    except BaseException:
        stop_cpu_checks(jobs)
        raise
    return jobs


def finish_single_cpu_checks(jobs, card_outs):
    try:
        for label, path, cmd, p in jobs:
            err = p.communicate(timeout=900)[1]
            check(p.returncode == 0,
                  f"{' '.join(cmd)} exited {p.returncode}: {err}")
            with open(path) as f:
                check(f.read() == card_outs[label],
                      f"single {label}: card and CPU stdout differ")
    finally:
        stop_cpu_checks(jobs)
    return sorted(label for label, *_ in jobs)


def profile_single(torch, fn):
    """One warm call of ``fn`` under torch.profiler: its wall, the device
    time of its ops and their count."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops = device_ops(prof)
    device_ms = sum(o["ms"] for o in ops)
    return {"wall_ms": wall * 1e3, "device_time_ms": device_ms,
            "device_share": device_ms / 1e3 / wall, "device_ops": ops[:6]}


def phase_single(torch, scan, ptr, tb, work):
    """The per-mode CLI (``aligntools-torch MODE [opts] FILE``) through
    cli.main in-process on the card, with the counts set to 0 just before
    and read just after; every stdout held against ALIGNTOOLS_DEVICE=cpu
    (the small ones in-process, the long ones in one-thread processes
    beside the timings); warm api.align_pair times; the cold wall of a
    fresh process and its split; the native C++ CLI beside it."""
    from aligntools_tpu_torch import api, cli
    from aligntools_tpu_torch.params import AlignParams

    runs = [(" ".join(a), [*a[:-1], os.path.join(ROOT, "test", a[-1])])
            for a in SINGLE_FIXTURES]
    pairs = {}
    for k, mode in enumerate(SINGLE_MODES):
        q, t, _ = drawn_pair(SINGLE_N, SINGLE_N, SEED + k)
        pairs[f"{mode}-{SINGLE_N}"] = (mode, q, t, None)
    for k, (label, (mode, m, n, with_sites)) in enumerate(
            SINGLE_LONG.items()):
        pairs[label] = (mode, *drawn_pair(m, n, SEED + 10 + k, with_sites))
    for label, (mode, q, t, sites) in pairs.items():
        path = os.path.join(work, f"single-{label}.fa")
        write_fasta(path, [(q, t)], [sites] if sites else None)
        runs.append((label, [mode, *(["-s"] if sites else []), path]))
    long_runs = [(label, argv) for label, argv in runs
                 if label in SINGLE_LONG]
    jobs = start_single_cpu_checks(work, long_runs)
    try:
        reset_counts(scan, ptr, tb)
        card = {label: run_single(cli, argv, None) for label, argv in runs}
        torch.cuda.synchronize()
        launches, plain = counts(scan, ptr, tb)
        emit({"phase": "single", "runs": len(runs),
              "launches": launches, "plain_calls": plain})
        for name in ("ptr", "walk", "edit", "blocked_ptr",
                     "blocked_scores"):
            check(launches[name] > 0,
                  f"kernel {name} never launched on the single-pair path")
        check(not any(plain.values()), f"plain versions ran on the card "
              f"on the single-pair path: {plain}")
        check_no_double(launches, "the single-pair path in range")
        for label, argv in runs:
            if label in SINGLE_LONG:
                continue
            out, _ = run_single(cli, argv, "cpu")
            check(card[label][0] == out,
                  f"single {label}: card and CPU stdout differ")
        emit({"phase": "single", "cpu_checked_in_process":
              len(runs) - len(long_runs)})

        # warm api.align_pair on the card, as the commands above call it
        timing = {}
        for label, (mode, q, t, sites) in pairs.items():
            reps = SINGLE_LONG_REPS if label in SINGLE_LONG else SINGLE_REPS
            walls = []
            for _ in range(reps):
                t0 = time.perf_counter()
                api.align_pair(mode, q, t, AlignParams(), sites,
                               device="cuda")
                walls.append((time.perf_counter() - t0) * 1e3)
            timing[label] = {"ms": statistics.median(walls),
                             "walls_ms": walls, "m": len(q), "n": len(t),
                             "cli_wall_s": card[label][1]}
            emit({"phase": "single", "pair": label, "mode": mode,
                  "shape": f"{len(q)}x{len(t)}",
                  "sites": sites is not None, **timing[label]})
        for label in (f"global-{SINGLE_N}", "fit-B1"):
            mode, q, t, sites = pairs[label]
            emit({"phase": "single", "profile": label, **profile_single(
                torch, lambda: api.align_pair(mode, q, t, AlignParams(),
                                              sites, device="cuda"))})

        # the cold wall of a fresh process, the kernels already built
        env = {k: v for k, v in os.environ.items()
               if k != "ALIGNTOOLS_DEVICE"}
        fixture = " ".join(COLD_ARGV[:-1] + ("test_global.fa",))
        out, walls = timed_runs([sys.executable, "-m",
                                 "aligntools_tpu_torch", *COLD_ARGV],
                                COLD_REPS, env)
        check(out == card[fixture][0], "cold process: stdout differs from "
              "the in-process run")
        splits = []
        for _ in range(COLD_REPS):
            r = subprocess.run([sys.executable, "-c", COLD_SPLIT, *COLD_ARGV],
                               cwd=ROOT, env=env, capture_output=True,
                               text=True, timeout=300)
            check(r.returncode == 0, f"cold split exited {r.returncode}: "
                  f"{r.stderr}")
            splits.append(json.loads(r.stdout.strip().splitlines()[-1]))
            check(splits[-1]["rc"] == 0, f"cold split: {splits[-1]}")
        split = {k: statistics.median(s[k] for s in splits)
                 for k in splits[0] if k != "rc"}
        cold = {"phase": "single", "cold": " ".join(COLD_ARGV),
                "wall_s": statistics.median(walls), "walls_s": walls,
                "split_s": split, **native_anchor(out)}
        emit(cold)
        checked = finish_single_cpu_checks(jobs, {
            label: card[label][0] for label, _ in long_runs})
    finally:
        stop_cpu_checks(jobs)
    emit({"phase": "single", "cpu_checked_long": checked})
    return {"launches": launches, "timing": timing, "cold": cold}


class StampedOut(io.StringIO):
    """A text stream that notes the clock at each terminator line."""

    def __init__(self):
        super().__init__()
        self.stamps = []

    def write(self, s):
        if s.startswith("#"):
            self.stamps.append(time.perf_counter())
        return super().write(s)


def phase_serve(torch, scan, ptr, tb, slice_out):
    """serve() fed one stream on the 2,000-pair FASTA of the slice phase:
    each request's TSV byte for byte the batch TSV the slice phase wrote
    for the same mode and output (a sharded request: the scores TSV, on a
    one-rank NCCL group); a malformed request answered with #error; nothing
    after quit processed."""
    from aligntools_tpu_torch.serve import serve

    fasta = slice_out["fasta"]
    # (label, request line, the slice phase's TSV it must equal)
    requests = [
        ("overlap scores_only", f"overlap {fasta} scores_only",
         slice_out["scores"]["overlap"]),
        ("global rows", f"global {fasta}", slice_out["rows"]["global"]),
        ("fit sites rows", f"fit {fasta} sites", slice_out["rows"]["fit"]),
        ("edit", f"edit {fasta}", slice_out["scores"]["edit"]),
        ("overlap scores_only warm", f"overlap {fasta} scores_only",
         slice_out["scores"]["overlap"]),
        ("malformed", "global", None),
        ("sharded", f"overlap {fasta} sharded",
         slice_out["scores"]["overlap"]),
    ]
    lines = [line for _, line, _ in requests] + ["quit", f"global {fasta}"]
    handed = []

    def stream():
        for line in lines:
            handed.append(time.perf_counter())
            yield line + "\n"

    out = StampedOut()
    reset_counts(scan, ptr, tb)
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = serve(stream(), out, device="cuda")
    torch.cuda.synchronize()
    launches, plain = counts(scan, ptr, tb)
    check(rc == 0, f"serve returned {rc}: {err.getvalue()}")
    check(len(handed) == len(requests) + 1,
          f"serve read {len(handed)} lines; it must stop at quit")
    blocks, cur = [], []
    for ln in out.getvalue().splitlines(keepends=True):
        if ln.startswith("#"):
            blocks.append(("".join(cur), ln.rstrip("\n")))
            cur = []
        else:
            cur.append(ln)
    check(not cur and len(blocks) == len(requests) == len(out.stamps),
          f"serve wrote {len(blocks)} terminators for {len(requests)} "
          f"requests")
    errors = 0
    for k, ((label, _, want), (tsv, term)) in enumerate(zip(requests,
                                                            blocks)):
        seconds = out.stamps[k] - handed[k]
        if want is None:
            check(term.startswith("#error") and not tsv,
                  f"serve {label}: {term!r}, expected #error")
            errors += 1
            emit({"phase": "serve", "request": label, "terminator": term,
                  "seconds": seconds})
            continue
        with open(want) as f:
            want = f.read()
        n = want.count("\n")
        check(term.startswith(f"#done pairs={n} "),
              f"serve {label}: {term!r} for {n} pairs")
        check(tsv == want, f"serve {label}: TSV differs from the slice "
              f"phase's batch TSV")
        emit({"phase": "serve", "request": label, "pairs": n,
              "seconds": seconds, "pairs_per_s": n / seconds,
              "terminator": term})
    check(errors == 1, f"serve: {errors} #error lines, expected 1")
    emit({"phase": "serve", "launches": launches, "plain_calls": plain})
    for name in ("overlap", "edit", "ptr", "walk"):
        check(launches[name] > 0, f"kernel {name} never launched in serve")
    check(not any(plain.values()), f"plain versions ran in serve: {plain}")
    return launches


# the parallel phase: --sharded at one rank (NCCL) on every
# PAR_SAMPLE_EVERY-th pair of the slice phase's 2,000; PAR_RANKS ranks
# (gloo) on the one card; the related pair of seqpar_align; each EDGE
# instance checked at one chunk of PAR_CHUNK rows at row PAR_CHUNK of rank
# 1 of PAR_RANKS (the walk at rank PAR_RANKS-1's slab, where it starts)
PAR_SAMPLE_EVERY = 8
PAR_RANKS = 4
PAR_ALIGN = (2050, 20480)
PAR_CHUNK = 256
PAR_TIMED = 3
PAR_SCORE_VARIANTS = ("global", "local", "overlap", "edit", "fit",
                      "fit+jump")
PAR_ALIGN_VARIANTS = ("global", "local", "overlap", "fit+jump")
PAR_LAUNCHES = ("edge_scores", "edge_ptr", "walk", "walk_col_pause")


def parallel_inputs():
    """The parallel phase's pairs, made from SEED (every rank rebuilds
    them): B1 (1,327 x 114,491, three junction sites), L1's eight ragged
    pairs in (1,024, 65,536) with their sites, the related 2,050 x 20,480
    pair of seqpar_align with its sites."""
    import numpy as np

    from aligntools_tpu_torch.utils.synth import related_pair

    rng = np.random.default_rng(SEED)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)

    def seq(k):
        return acgt[rng.integers(0, 4, k)].tobytes()

    def sites(n, k=3):
        return sorted(int(x) for x in rng.integers(0, n, k))

    b1 = (seq(BLOCKED_B1[3]), seq(BLOCKED_B1[4]))
    l1 = []
    for _ in range(BLOCKED_L1[0]):
        m = int(rng.integers(BLOCKED_L1[1] // 2, BLOCKED_L1[1] + 1))
        n = int(rng.integers(BLOCKED_L1[2] // 2, BLOCKED_L1[2] + 1))
        l1.append((seq(m), seq(n)))
    # the query from the window that crosses the boundary of ranks 2 and 3
    # (at D 4), so that every mode's walk hands over between ranks
    rel = related_pair(*PAR_ALIGN, seed=SEED, offset=3 * PAR_ALIGN[1]
                       // PAR_RANKS - PAR_ALIGN[0] // 2)
    return {"b1": b1, "b1_sites": sites(len(b1[1])), "l1": l1,
            "l1_sites": [sites(len(t)) for _, t in l1], "align": rel,
            "align_sites": sites(len(rel[1]))}


def par_counts():
    from aligntools_tpu_torch.engine import device_tb as tb
    from aligntools_tpu_torch.ops import blocked, ptr, scan

    return ({"edge_scores": blocked.launches["edge_scores"],
             "edge_ptr": blocked.launches["edge_ptr"], "walk": tb.launches,
             "walk_col_pause": tb.col_pause_launches},
            scan.plain_calls + ptr.plain_calls + tb.plain_calls
            + blocked.plain_calls)


def par_main_path(mesh_seq, mesh_grid, inp):
    """seqpar_score on B1 (each score variant), seqpar_batch_scores on L1
    and seqpar_align on the related pair (each align variant), as a user
    calls them: {label: result}."""
    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.parallel import seqpar

    p, out = AlignParams(), {}
    for v in PAR_SCORE_VARIANTS:
        mode, jump = v.split("+")[0], v.endswith("+jump")
        out[f"score/{v}"] = seqpar.seqpar_score(
            mode, *inp["b1"], p, inp["b1_sites"] if jump else None, mesh_seq)
        out[f"batch/{v}"] = seqpar.seqpar_batch_scores(
            mode, inp["l1"], p, inp["l1_sites"] if jump else None,
            mesh_grid).tolist()
    for v in PAR_ALIGN_VARIANTS:
        mode, jump = v.split("+")[0], v.endswith("+jump")
        r = seqpar.seqpar_align(mode, *inp["align"], p,
                                inp["align_sites"] if jump else None,
                                mesh_seq)
        out[f"align/{v}"] = [r.score, r.row1.decode(), r.row2.decode()]
    return out


def par_score_ms(torch, fn, barrier=lambda: None):
    """Median host wall of PAR_TIMED calls, each between barriers and
    ending in a synchronize, in ms."""
    times = []
    for _ in range(PAR_TIMED):
        barrier()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        barrier()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rank_main(opts):
    """One of PAR_RANKS gloo ranks on the one card (spawned by the parallel
    phase): the main path from counts set to 0, the counts and results to
    rank 0, which writes them to opts.out; a failure ends every rank."""
    import numpy as np
    import torch
    import torch.distributed as dist

    sys.path.insert(0, ROOT)
    from aligntools_tpu_torch.engine import device_tb as tb
    from aligntools_tpu_torch.ops import _build, blocked, ptr, scan
    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.parallel import distributed, mesh, seqpar

    dist.init_process_group(
        "gloo", store=dist.FileStore(opts.store, opts.world), rank=opts.rank,
        world_size=opts.world, timeout=datetime.timedelta(seconds=300))
    try:
        _build.load()
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        seq = mesh.make_mesh(axis="seq", device=dev, backend="gloo")
        grid = mesh.make_mesh(axis=("data", "seq"), shape=(2, opts.world // 2),
                              device=dev, backend="gloo")
        inp = parallel_inputs()
        for m in (scan, ptr, tb, blocked):
            m.reset_counts()
        res = par_main_path(seq, grid, inp)
        torch.cuda.synchronize()
        launches, plain = par_counts()
        fit = lambda: seqpar.seqpar_score("fit", *inp["b1"], AlignParams(),
                                          inp["b1_sites"], seq)
        ms = par_score_ms(torch, fit, distributed.barrier)
        row = np.array([launches[k] for k in PAR_LAUNCHES] + [plain],
                       np.int64)[None]
        allc = distributed.gather_to_host0(row)
        if opts.rank == 0:
            res["launches"] = dict(zip(PAR_LAUNCHES,
                                       allc[:, :-1].sum(0).tolist()))
            res["plain_calls"] = int(allc[:, -1].sum())
            res["fit_jump_ms"] = ms
            with open(opts.out, "w") as f:
                json.dump(res, f)
        distributed.barrier("aligntools-done")
    except Exception as err:  # every failure ends the whole job
        distributed.abort_all(err)
    dist.destroy_process_group()
    return 0


def par_kernel_rows(torch, inp):
    """Each new instance against its plain version (on the CPU, same
    inputs), at one chunk of the main path's shapes: the EDGE score fills
    at rank 1 of PAR_RANKS of B1 (random integer top rows and left edge,
    -inf among them), the EDGE pointer fills at rank 1 of the related
    pair, the column-paused walk over rank PAR_RANKS-1's slab of the
    related pair's whole fill, from its start (one in the middle of that
    slab where the start lies on rank 0); each timed (warm median of three,
    the wrapper's host work included) beside its bound and the plain
    version's one call."""
    import numpy as np

    from aligntools_tpu_torch import layout
    from aligntools_tpu_torch.convert import params_matrix
    from aligntools_tpu_torch.engine import device_tb as tb
    from aligntools_tpu_torch.ops import blocked, ptr, scan
    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.parallel import seqpar

    dev, cpu = torch.device("cuda"), torch.device("cpu")
    rng = np.random.default_rng(SEED)
    rows = []

    def row(kernel, variant, shape, fn, plain, args, ops, nbytes, **extra):
        got = [x.cpu() for x in fn(*[a.to(dev) if a is not None else None
                                     for a in args])]
        torch.cuda.synchronize()
        ms_k = statistics.median(timed_ms(torch, lambda: fn(*[
            a.to(dev) if a is not None else None for a in args]))
            for _ in range(3))
        t0 = time.perf_counter()
        want = plain(*[a.clone() if a is not None else None for a in args])
        ms_p = (time.perf_counter() - t0) * 1e3
        eq = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        b_ms, b_by = bound(ops, nbytes)
        rows.append({"phase": "parallel", "kernel": kernel,
                     "variant": variant, "shape": shape, "bit_equal": eq,
                     "max_abs_err": err, "tolerance": TOL, "ms": ms_k,
                     "plain_ms": ms_p, "plain_device": "cpu",
                     "bound_ms": b_ms, "bound_by": b_by,
                     "probe_ms": probe_ms(ops, kernel.startswith("walk")
                                          or variant == "edit"), **extra})
        emit(rows[-1])
        check(eq and err == 0.0, f"{kernel} {variant} at {shape}: "
              f"kernel != plain")

    def chunk_inputs(q, t, sites, kind, mode, jump, n_loc, col0):
        R, i0 = PAR_CHUNK, PAR_CHUNK
        qa = np.full(R, -1, np.int32)
        part = np.frombuffer(q[i0 : i0 + R], np.uint8)
        qa[: len(part)] = part
        ta = np.full(n_loc, -2, np.int32)
        part = np.frombuffer(t[col0 : col0 + n_loc], np.uint8)
        ta[: len(part)] = part
        allow = np.ones(n_loc, np.float32)
        for s in sites or []:
            if col0 <= s < col0 + n_loc:
                allow[s - col0] = 0.0
        n_top = scan.EDGE_TOP[mode] if kind == "scores" else \
            ptr.TOP_STATES[mode]
        n_edge = (scan.edge_states(mode, jump) if kind == "scores"
                  else ptr.edge_states(mode, jump))
        dt = np.int32 if mode == "edit" else np.float32
        top = rng.integers(-60, 60, (1, n_top, n_loc)).astype(dt)
        ledge = rng.integers(-60, 60, (1, n_edge, R + 1)).astype(dt)
        if mode != "edit":
            top[rng.random(top.shape) < 0.02] = -np.inf
            ledge[rng.random(ledge.shape) < 0.02] = -np.inf
        t_ = lambda a: torch.from_numpy(np.ascontiguousarray(a))
        return (t_(qa[None]), t_(ta[None]), t_(allow[None]) if jump else
                None, torch.tensor([[len(t)]], dtype=torch.int32),
                torch.tensor([[len(q)]], dtype=torch.int32),
                params_matrix(AlignParams(), cpu), t_(top), t_(ledge))

    q, t = inp["b1"]
    n_loc = seqpar.slice_width(len(t), PAR_RANKS)
    c_blk = seqpar.edge_c_blk(n_loc)
    for v in PAR_SCORE_VARIANTS:
        mode, jump = v.split("+")[0], v.endswith("+jump")
        args = chunk_inputs(q, t, inp["b1_sites"], "scores", mode, jump,
                            n_loc, n_loc)
        acc = torch.tensor([INT32_MAX if mode == "edit" else -1e9],
                           dtype=scan.edge_dtype(mode))

        def fn(*a, mode=mode, jump=jump):
            acc_k = acc.clone().to(a[0].device)
            return (*blocked.edge_scores(mode, jump, n_loc, PAR_CHUNK, c_blk,
                                         *a, acc_k), acc_k)

        def plain(*a, mode=mode, jump=jump):
            acc_p = acc.clone()
            return (*scan.edge_scores_plain(mode, jump, n_loc, PAR_CHUNK,
                                            *a, acc_p), acc_p)

        cells = PAR_CHUNK * n_loc
        val = 4
        row("edge_scores", v, f"{len(q)}x{len(t)}/D{PAR_RANKS} rank 1 "
            f"rows {PAR_CHUNK + 1}-{2 * PAR_CHUNK}", fn, plain, args,
            SCORE_OPS[v] * cells, val * (args[6].numel() * 2 + 2 * args[7]
                                        .numel()) + 4 * (PAR_CHUNK + n_loc
                                                         * (2 if jump else
                                                            1)) + 8,
            c_blk=c_blk)

    q, t = inp["align"]
    n_loc = seqpar.slice_width(len(t), PAR_RANKS)
    c_blk = seqpar.edge_c_blk(n_loc)
    for v in PAR_ALIGN_VARIANTS:
        mode, jump = v.split("+")[0], v.endswith("+jump")
        rpb = layout.rows_per_byte(mode, jump, PAR_CHUNK)
        args = chunk_inputs(q, t, inp["align_sites"], "ptr", mode, jump,
                            n_loc, n_loc)
        cand = torch.tensor([[torch.tensor(-1e9).view(torch.int32).item(),
                              0, 0, 0]], dtype=torch.int32)

        def fn(*a, mode=mode, jump=jump, rpb=rpb):
            c = cand.clone().to(a[0].device)
            slab = torch.zeros((1, 2 * PAR_CHUNK // rpb, n_loc),
                               dtype=torch.uint8, device=a[0].device)
            return (*blocked.edge_ptr_fill(mode, jump, n_loc, PAR_CHUNK,
                                           c_blk, *a, c, slab, rpb), c, slab)

        def plain(*a, mode=mode, jump=jump, rpb=rpb):
            c = cand.clone()
            slab = torch.zeros((1, 2 * PAR_CHUNK // rpb, n_loc),
                               dtype=torch.uint8)
            chunk, bottom, redge = ptr.ptr_fill_plain(
                mode, jump, PAR_CHUNK, n_loc, *a[:6], rpb, seed=a[6],
                i0=PAR_CHUNK, col0=n_loc, edge=a[7], cand=c)
            slab[:, PAR_CHUNK // rpb :] = chunk
            return bottom, redge, c, slab

        cells = PAR_CHUNK * n_loc
        row("edge_ptr", f"{v}/rpb{rpb}", f"{len(q)}x{len(t)}/D{PAR_RANKS} "
            f"rank 1 rows {PAR_CHUNK + 1}-{2 * PAR_CHUNK}", fn, plain, args,
            (SCORE_OPS[v] + PTR_EXTRA_OPS[v]) * cells,
            4 * (args[6].numel() * 2 + 2 * args[7].numel() + PAR_CHUNK
                 + n_loc * (2 if jump else 1)) + cells // rpb + 16,
            c_blk=c_blk)

    # the walk: rank PAR_RANKS-1's slab of the whole fill, from the start
    m, n = len(q), len(t)
    for v in PAR_ALIGN_VARIANTS:
        mode, jump = v.split("+")[0], v.endswith("+jump")
        from aligntools_tpu_torch import batch

        sl = [inp["align_sites"]] if jump else None
        bk = batch._bucketize([(q, t)], sl, keys=[(-(-m // 32) * 32,
                                                   PAR_RANKS * n_loc)])
        b = next(iter(bk.values()))
        qs, ts, allow, ns, ms = batch._bucket_tensors(b, dev)
        if jump and allow is None:
            allow = torch.ones_like(ts, dtype=torch.float32)
        rpb = layout.rows_per_byte(mode, jump, b.m_pad)
        pm = params_matrix(AlignParams(), dev)
        score, a, bb, ptrs = ptr.ptr_fill(mode, jump, b.m_pad, b.n_pad, qs, ts,
                                          allow, ns, ms, pm, rpb)
        starts = tb.walk_starts(mode, score, a, bb, ms, ns)
        if int(starts[2, 0]) <= n_loc:
            # a start on rank 0 (overlap's at j 0 here) takes no column
            # pause: the walk from the middle of the last rank's slab
            starts[2, 0] = (PAR_RANKS - 1) * n_loc + n_loc // 2
        j0 = int(starts[2, 0])
        d = (j0 - 1) // n_loc
        col0 = d * n_loc
        slab = ptrs[:, :, col0 : col0 + n_loc].contiguous()
        tloc = ts[:, col0 : col0 + n_loc].contiguous()
        del ptrs
        fn = lambda *a, mode=mode, rpb=rpb, col0=col0: tb.walk(
            mode, rpb, *a, col0=col0)
        plain = lambda *a, mode=mode, rpb=rpb, col0=col0: tb.walk_plain(
            mode, rpb, *a, col0=col0)
        got = fn(slab, qs, tloc, starts)
        steps = int(got[2][0, 0])
        row("walk_col_pause", f"{v}/rpb{rpb}", f"{m}x{n}/D{PAR_RANKS} rank "
            f"{d}", fn, plain, (slab.cpu(), qs.cpu(), tloc.cpu(),
                                starts.cpu()),
            WALK_OPS_PER_STEP * steps, WALK_BYTES_PER_STEP * steps + 32,
            steps=steps, chain_ms=chain_ms(steps))
    return rows


def phase_parallel(torch, scan, ptr, tb, work, slice_out):
    """The parallel package (aligntools_tpu_torch/parallel/) on the card.

      sharded  `batch MODE --sharded` through cli.main in-process, on a
               one-rank NCCL group, for the five modes (fit with -s), on
               every PAR_SAMPLE_EVERY-th pair of the slice phase's 2,000:
               each TSV byte for byte the same run's `--scores-only` TSV;
      kernels  each new instance against its plain version (par_kernel_rows);
      D1       the main path at one rank (seq mesh of 1, grid (1, 1)), the
               counts set to 0 just before and read just after: each result
               bit-equal (rows byte-equal) to the single-device route of the
               same run; seqpar_score's fit+jump on B1 timed against the
               blocked route (what the chunking costs);
      ranks    PAR_RANKS gloo ranks spawned on the one card (NCCL refuses two
               ranks a card), each the same main path over seq PAR_RANKS and
               grid (2, PAR_RANKS / 2), held to the same single-device
               results; their counts summed; seqpar_score's fit+jump at D
               PAR_RANKS timed (the ranks time-slice the one card: no
               scaling figure)."""
    from aligntools_tpu_torch import batch, cli
    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.parallel import mesh, seqpar

    t_phase = time.perf_counter()
    lines = read_lines(slice_out["fasta"])
    sample_fa = os.path.join(work, "sharded_sample.fa")
    keep = [lines[k : k + 4] for k in range(0, len(lines), 4)][
        ::PAR_SAMPLE_EVERY]
    with open(sample_fa, "w") as f:
        f.write("\n".join(sum(keep, [])) + "\n")
    reset_counts(scan, ptr, tb)
    for mode in ("global", "local", "overlap", "edit", "fit"):
        extra = ["-s"] if mode == "fit" else []
        outs = {}
        for flag in ("--sharded", "--scores-only"):
            outs[flag] = os.path.join(work, f"par_{mode}{flag}.tsv")
            wall, _ = run_cli(cli, ["batch", mode, sample_fa, flag, *extra,
                                    "--out", outs[flag]])
        with open(outs["--sharded"], "rb") as f1, \
                open(outs["--scores-only"], "rb") as f2:
            a, b = f1.read(), f2.read()
        check(a == b and a.count(b"\n") == len(keep),
              f"batch {mode} --sharded differs from --scores-only")
        emit({"phase": "parallel", "sharded": mode + " -s" * bool(extra),
              "pairs": len(keep), "byte_equal": True, "seconds": wall})
    launches, plain = counts(scan, ptr, tb)
    check(not any(plain.values()), f"plain versions ran in --sharded: "
          f"{plain}")

    inp = parallel_inputs()
    rows = par_kernel_rows(torch, inp)

    # the single-device route's results, before the counts are reset
    p, want = AlignParams(), {}
    for v in PAR_SCORE_VARIANTS:
        mode, jump = v.split("+")[0], v.endswith("+jump")
        want[f"score/{v}"] = float(batch.batch_scores(
            mode, [inp["b1"]], p, [inp["b1_sites"]] if jump else None,
            device="cuda")[0])
        want[f"batch/{v}"] = batch.batch_scores(
            mode, inp["l1"], p, inp["l1_sites"] if jump else None,
            device="cuda").tolist()
    for v in PAR_ALIGN_VARIANTS:
        mode, jump = v.split("+")[0], v.endswith("+jump")
        r = batch.align_batch(mode, [inp["align"]], p,
                              [inp["align_sites"]] if jump else None,
                              traceback=True, device="cuda")[0]
        want[f"align/{v}"] = [r.score, r.row1.decode(), r.row2.decode()]

    def held(got, where):
        for k, w in want.items():
            g = got[k]
            check(g == w, f"{where}: {k} differs from the single-device "
                  f"route")

    seq1 = mesh.make_mesh(axis="seq", device="cuda")
    grid1 = mesh.make_mesh(axis=("data", "seq"), shape=(1, 1),
                           device="cuda")
    check(seq1.backend == "nccl", "the one-rank mesh is not NCCL's")
    for m in (scan, ptr, tb):
        m.reset_counts()
    from aligntools_tpu_torch.ops import blocked

    blocked.reset_counts()
    got = par_main_path(seq1, grid1, inp)
    torch.cuda.synchronize()
    d1_launches, d1_plain = par_counts()
    held({k: (float(v) if k.startswith("score/") else v)
          for k, v in got.items()}, "D1")
    check(d1_plain == 0, f"plain versions ran at D1: {d1_plain}")
    for k in ("edge_scores", "edge_ptr", "walk"):
        check(d1_launches[k] > 0, f"{k} never launched at D1")
    fit_args = ("fit", *inp["b1"], p, inp["b1_sites"])
    d1_ms = par_score_ms(torch, lambda: seqpar.seqpar_score(
        *fit_args, seq1))
    route_ms = par_score_ms(torch, lambda: batch.batch_scores(
        "fit", [inp["b1"]], p, [inp["b1_sites"]], device="cuda"))
    emit({"phase": "parallel", "D": 1, "launches": d1_launches,
          "seqpar_score_fit_jump_ms": d1_ms, "blocked_route_ms": route_ms,
          "chunk_rows": seqpar.chunk_rows(seqpar.slice_width(
              len(inp["b1"][1]), 1), seqpar.edge_c_blk(seqpar.slice_width(
                  len(inp["b1"][1]), 1))), "held": sorted(want)})

    out = os.path.join(work, "ranks.json")
    store = os.path.join(work, "ranks.store")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--rank", str(r),
         "--world", str(PAR_RANKS), "--store", store, "--out", out],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(PAR_RANKS)]
    errs = []
    try:
        for pr in procs:
            errs.append(pr.communicate(timeout=600)[1])
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    rcs = [pr.returncode for pr in procs]
    check(rcs == [0] * PAR_RANKS, f"ranks exited {rcs}: "
          f"{[e[-2000:] for e in errs]}")
    with open(out) as f:
        res = json.load(f)
    held(res, f"D{PAR_RANKS}")
    check(res["plain_calls"] == 0, f"plain versions ran on the ranks: "
          f"{res['plain_calls']}")
    for k in PAR_LAUNCHES:
        check(res["launches"][k] > 0, f"{k} never launched on the ranks")
    emit({"phase": "parallel", "D": PAR_RANKS, "backend": "gloo",
          "launches": res["launches"],
          "seqpar_score_fit_jump_ms_time_sliced": res["fit_jump_ms"],
          "held": sorted(want), "seconds": time.perf_counter() - t_phase})
    total = {k: d1_launches[k] + res["launches"][k] for k in PAR_LAUNCHES}
    return total, rows


def long_pairs(P, seed):
    """The L3 read set: m ~ lognormal(1,300, 0.2), n uniform in 40,000 to
    131,072, random ACGT; three junction sites a target."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    ms = np.exp(rng.normal(np.log(1300), 0.2, P)).astype(int)
    ns = rng.integers(40000, 131073, P)
    pairs = [(alpha[rng.integers(0, 4, m)].tobytes(),
              alpha[rng.integers(0, 4, n)].tobytes()) for m, n in zip(ms, ns)]
    sites = [sorted(int(x) for x in rng.integers(0, n, 3)) for n in ns]
    return pairs, sites


def phase_long(torch, scan, ptr, tb, work, trace_path):
    """The main path on long targets (L3, global/local on its first 4, and
    a mixed flat + blocked local run): the runs, with the counts set to 0
    just before and read just after, then every bucket against plain while
    the CPU runs of the sampled pairs go on."""
    from aligntools_tpu_torch import batch, cli
    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.utils.synth import clustered_pairs

    params = AlignParams()
    # enough pairs that the rows run's padded pointers pass the budget
    budget = int(batch._hbm_budget(torch.device("cuda"))
                 * batch.PTR_BUDGET_FRAC)
    P = LONG_PAIRS
    while True:
        pairs, sites = long_pairs(P, SEED)
        ptr_bytes = sum(m * n for m, n in batch._bucket_keys(pairs, 64, 128))
        if ptr_bytes > budget:
            break
        P += 32
    emit({"phase": "long", "pairs": P, "padded_pointer_bytes": ptr_bytes,
          "pointer_budget": budget,
          "true_cells": sum(len(q) * len(t) for q, t in pairs)})
    mixed = clustered_pairs(2000, seed=SEED) + pairs[:32]
    runs_in = {  # label -> (mode, pairs, sites)
        "fit": ("fit", pairs, sites),
        "global": ("global", pairs[:LONG_AFFINE_PAIRS], None),
        "local": ("local", pairs[:LONG_AFFINE_PAIRS], None),
        "mixed": ("local", mixed, None),
    }
    fastas = {}
    for label, (mode, ps, s) in runs_in.items():
        fastas[label] = os.path.join(work, f"long-{label}.fa")
        write_fasta(fastas[label], ps, s)

    waves = [0]
    collect = batch._collect_rows_wave

    def counted(mode, pends, *rest):  # the router's flush waves
        waves[0] += bool(pends)
        return collect(mode, pends, *rest)

    def run(label, run_label, rows):
        mode, ps, s = runs_in[label]
        tsv = os.path.join(work, f"long-{label}-{'rows' if rows else 'scores'}"
                                 f"-{run_label.replace(' ', '-')}.tsv")
        argv = ["batch", mode, fastas[label], *(["-s"] if s else []),
                *([] if rows else ["--scores-only"]), "--out", tsv]
        waves[0] = 0
        wall, report = run_cli(cli, argv)
        n_cells = sum(len(q) * len(t) for q, t in ps)
        emit({"phase": "long", "path": "rows" if rows else "scores",
              "run": f"{label} ({mode}{' -s' if s else ''}) {run_label}",
              "pairs": len(ps), "seconds": wall,
              "pairs_per_s": len(ps) / wall,
              "true_gcups": n_cells / wall / 1e9,
              **({"waves": waves[0]} if rows else {}), "counters": report})
        return tsv

    batch._collect_rows_wave = counted
    try:
        reset_counts(scan, ptr, tb)
        cold = run("fit", "cold", True)
        check(waves[0] >= 2, f"L3 rows ran in {waves[0]} wave(s); the "
              f"pointer budget should split it")
        rows_tsv = {"fit": run("fit", "warm", True)}
        scores_tsv = {"fit": run("fit", "warm", False)}
        for label in ("global", "local", "mixed"):
            rows_tsv[label] = run(label, "cold", True)
            scores_tsv[label] = run(label, "cold", False)
        torch.cuda.synchronize()
        launches, plain = counts(scan, ptr, tb)
    finally:
        batch._collect_rows_wave = collect
    emit({"phase": "long", "launches": launches, "plain_calls": plain})
    for name in ("blocked_scores", "blocked_ptr", "walk"):
        check(launches[name] > 0,
              f"kernel {name} never launched on the long-target path")
    check(not any(plain.values()), f"plain versions ran on the long-target "
          f"path: {plain}")
    with open(cold, "rb") as a, open(rows_tsv["fit"], "rb") as b:
        check(a.read() == b.read(), "L3: cold and warm rows TSVs differ")
    # the L3 rows warm profile, on every run: the walk's time, its share of
    # the busy time, its SMs in use and how much of it ran under a fill
    root, ext = os.path.splitext(trace_path or os.path.join(work,
                                                            "trace.json"))
    phase_profile(torch, cli, ["batch", "fit", fastas["fit"], "-s"], work,
                  f"{root}.long{ext}")

    runs = []
    for label, tsv in rows_tsv.items():
        mode, ps, s = runs_in[label]
        cost = sorted(range(len(ps)),
                      key=lambda k: len(ps[k][0]) * len(ps[k][1]))
        pool = [k for k in cost if batch.PALLAS_FLAT_MAX_N_PAD < len(ps[k][1])
                <= LONG_SAMPLE_MAX_N][:LONG_POOL]
        groups = [sample(pool, min(LONG_SAMPLES, len(pool)))]
        if label == "fit":  # and one target past LONG_FAR_N columns
            groups.append([next(k for k in cost
                                if len(ps[k][1]) > LONG_FAR_N)])
        runs.append((f"long-{label}", mode, tsv, scores_tsv[label], ps, s,
                     groups))
    # the CPU runs of the sampled pairs go on beside the bucket checks
    jobs = start_cpu_checks(work, runs)
    try:
        checked_buckets, long_walks = [], []
        for label, (mode, ps, s) in runs_in.items():
            variant = "fit+jump" if s else mode
            for rows in (False, True):
                checked_buckets.append(phase_buckets(
                    torch, scan, ptr, tb, variant, ps, s, params, rows,
                    long_walks if label == "fit" else None,
                    check_every=LONG_CHECK_EVERY.get(label, 1)))
        check(long_walks, "no L3 bucket's walk was held against plain")
        checked = finish_cpu_checks(jobs)
    finally:
        stop_cpu_checks(jobs)
    emit({"phase": "long", "rows_equal_scores": sorted(rows_tsv),
          "cpu_checked": checked})
    return launches, checked_buckets, long_walks


def banded_kernel_inputs(torch, B, L, band, seed, extra=0):
    """BK1's inputs on the card: B queries of L random bases, each target
    the query with 1% substitutions and ``extra`` random bases after it
    (m = L, n = L + extra), in the banded kernel's layout, default
    parameters."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8).astype(np.int32)
    qs = rng.choice(alpha, (B, L))
    ts = qs.copy()
    mut = rng.random((B, L)) < 0.01
    ts[mut] = rng.choice(alpha, int(mut.sum()))
    ts = np.concatenate([ts, rng.choice(alpha, (B, extra))], axis=1)
    n = L + extra
    te = np.full((B, band + n + 2 * band + 2), -2, np.int32)
    te[:, band : band + n] = ts
    pm = np.array([[1, -2, -5, -1, 0, 0, 0, 0]], np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x, dtype)).cuda()
            for x, dtype in ((qs, np.int32), (te, np.int32),
                             (np.full((B, 1), n), np.int32),
                             (np.full((B, 1), L), np.int32),
                             (pm, np.float32))]


def band_cells(ms, ns, band):
    """Cells of the matrices inside the band: what the recurrence needs."""
    import numpy as np

    total = 0
    for m, n in zip(ms, ns):
        i = np.arange(1, m + 1)
        total += int(np.clip(np.minimum(n, i + band) - np.maximum(1, i - band)
                             + 1, 0, None).sum())
    return total


def banded_variant_check(torch, banded, mode, with_ptrs, band, args, want,
                         shape):
    """One banded launch at ``shape`` against plain's outputs ``want``:
    (bit_equal, max_abs_err, warm median ms of three)."""
    def fn():
        return banded._launch(mode, with_ptrs, band, *args, shape=shape)

    got = fn()[:5 if with_ptrs else 2]
    torch.cuda.synchronize()
    equal = all(torch.equal(g, w) for g, w in zip(got, want))
    err = max([max_err(torch, g, w) for g, w in zip(got[:4], want)]
              + [0.0 if not with_ptrs or torch.equal(got[4], want[4])
                 else float("inf")])
    del got
    return equal, err, statistics.median(timed_ms(torch, fn)
                                         for _ in range(3))


def phase_banded_kernels(torch, banded):
    """The registers and local (spill) bytes of each instance of
    csrc/banded_fill.cu; BK1: the nine variants against plain, bit for bit,
    and timed, on the path launch_shape gives (the warp path) and on the
    CTA path, with each launch's path and strip. One plain call a mode, as
    in BKW (a score-only variant's plain_ms is its pointer fill's)."""
    from aligntools_tpu_torch.ops import _build

    emit({"phase": "banded", "resource_usage": resource_usage(
        _build.library_path(), ("banded_",))})
    rows = []
    for B, L, band in BANDED_BK1:
        args = banded_kernel_inputs(torch, B, L, band, SEED + 3)
        cells, V = B * L * L, 2 * band + 1
        need = band_cells([L] * B, [L] * B, band)
        in_bytes = sum(x.numel() * x.element_size() for x in args)
        shape = f"{B}x{L}/W{band}"
        wants = {}
        for mode, with_ptrs in BANDED_VARIANTS:  # each mode's pointers first
            fn = banded.banded_full if with_ptrs else banded.banded_scores
            plain = (banded.banded_full_plain if with_ptrs
                     else banded.banded_scores_plain)
            got = fn(mode, band, *args)
            torch.cuda.synchronize()
            # the plain version's time is its one comparison call's
            if mode not in wants:
                wants[mode] = timed_call(
                    torch, lambda: plain(mode, band, *args))
            want, ms_p = wants[mode]
            want = want[:5 if with_ptrs else 2]
            equal = all(torch.equal(g, w) for g, w in zip(got, want))
            err = max([max_err(torch, g, w) for g, w in zip(got[:4], want)]
                      + [0.0 if not with_ptrs or torch.equal(got[4], want[4])
                         else float("inf")])
            del got
            ms_k = statistics.median(
                timed_ms(torch, lambda: fn(mode, band, *args))
                for _ in range(3))
            cta = banded.cta_shape(band)
            cta_eq, cta_err, cta_ms = banded_variant_check(
                torch, banded, mode, with_ptrs, band, args, want, cta)
            out_bytes = 8 * B + (8 * B + B * L * banded.lanes_padded(band)
                                 if with_ptrs else 0)
            ops = (SCORE_OPS[mode]
                   + (PTR_EXTRA_OPS[mode] if with_ptrs else 0)) * need
            b_ms, b_by = bound(ops, in_bytes + out_bytes)
            path, threads, strip = banded.launch_shape(band)
            row = {"phase": "banded", "level": "BK1",
                   "variant": f"{mode}/ptrs" if with_ptrs else mode,
                   "shape": shape, "route": f"{path} {threads} threads",
                   "strip": strip, "bit_equal": equal and cta_eq,
                   "max_abs_err": max(err, cta_err), "tolerance": TOL,
                   "ms": ms_k, "cta_ms": cta_ms, "cta_shape": list(cta),
                   "plain_ms": ms_p,
                   "bound_ms": b_ms, "bound_by": b_by,
                   "probe_ms": probe_ms(ops, mode == "edit"),
                   "band_cells": B * L * V, "band_cells_in_matrix": need,
                   "true_cells": cells,
                   "gcups_band": B * L * V / ms_k / 1e6,
                   "gcups_true": cells / ms_k / 1e6}
            emit(row)
            check(equal and err == 0.0,
                  f"banded {row['variant']} at {shape}: kernel != plain")
            check(cta_eq and cta_err == 0.0,
                  f"banded {row['variant']} at {shape}, CTA path: kernel != "
                  f"plain")
            rows.append(row)
        del args, wants
        torch.cuda.empty_cache()
    phase_banded_paths(torch, banded)
    return rows + phase_banded_wide(torch, banded)


def phase_banded_wide(torch, banded):
    """BKW: the CTA path at the bands only it serves (BANDED_BKW), the nine
    variants through the wrapper's own route against plain, bit for bit,
    and timed (warm median of three) beside their bound, probe_ms, the
    parent commit's time (BKW_PARENT_MS) and the launch's shape and team
    geometry. One plain call a mode: the plain pointer fill holds the
    score-only variant's best and edge too (its plain_ms is that call's)."""
    rows = []
    for B, L, band, extra in BANDED_BKW:
        if 2 * band + 1 > banded.MAX_LANES and not hasattr(banded, "chunks"):
            continue  # `--only bkw` on a package that takes no chunks
        args = banded_kernel_inputs(torch, B, L, band, SEED + 11, extra)
        n, V = L + extra, 2 * band + 1
        need = band_cells([L] * B, [n] * B, band)
        in_bytes = sum(x.numel() * x.element_size() for x in args)
        shape = f"{B}x{L}/W{band}" + (f"/n+{extra}" if extra else "")
        try:  # the shape the wrapper launches (a parent's takes no batch)
            cta = banded.cta_shape(band, B)
            geometry = banded.cta_geometry(band, cta[1], cta[2])
        except TypeError:
            cta, geometry = banded.cta_shape(band), None
        wants = {}
        for mode, with_ptrs in BANDED_VARIANTS:  # each mode's pointers first
            if mode not in wants:
                plain = (banded.banded_full_plain if with_ptrs
                         else banded.banded_scores_plain)
                wants[mode] = timed_call(
                    torch, lambda: plain(mode, band, *args))
            want, ms_p = wants[mode]
            equal, err, ms_k = banded_variant_check(
                torch, banded, mode, with_ptrs, band, args,
                want[:5 if with_ptrs else 2], None)
            out_bytes = 8 * B + (8 * B + B * L * banded.lanes_padded(band)
                                 if with_ptrs else 0)
            ops = (SCORE_OPS[mode]
                   + (PTR_EXTRA_OPS[mode] if with_ptrs else 0)) * need
            b_ms, b_by = bound(ops, in_bytes + out_bytes)
            variant = f"{mode}/ptrs" if with_ptrs else mode
            row = {"phase": "banded", "level": "BKW", "variant": variant,
                   "shape": shape, "route": f"cta {cta[1]} threads",
                   "strip": cta[2], "geometry": geometry,
                   "bit_equal": equal, "max_abs_err": err, "tolerance": TOL,
                   "ms": ms_k,
                   "parent_ms": BKW_PARENT_MS.get(f"{variant} {shape}"),
                   "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                   "probe_ms": probe_ms(ops, mode == "edit"),
                   "band_cells": B * L * V, "band_cells_in_matrix": need,
                   "gcups_band": B * L * V / ms_k / 1e6}
            emit(row)
            check(equal and err == 0.0,
                  f"banded {variant} at {shape}, CTA path: kernel != plain")
            rows.append(row)
        del args, wants
        torch.cuda.empty_cache()
    return rows


def phase_banded_paths(torch, banded):
    """The two paths of the banded kernel at BANDED_PATHS' band and
    batches, where the warp path takes its widest strip (16 lanes a
    thread): the nine variants on each path against plain, bit for bit,
    and timed, warm medians of three, beside the path launch_shape picks."""
    for band, B in BANDED_PATHS:
        args = banded_kernel_inputs(torch, B, BANDED_PATHS_L, band, SEED + 7)
        shapes = {"warp": banded.launch_shape(band),
                  "cta": banded.cta_shape(band)}
        check(shapes["warp"][0] == "warp",
              f"launch_shape({band}) does not take the warp path")
        shape = f"{B}x{BANDED_PATHS_L}/W{band}"
        wants = {}
        for mode, with_ptrs in BANDED_VARIANTS:  # one plain call a mode
            plain = (banded.banded_full_plain if with_ptrs
                     else banded.banded_scores_plain)
            if mode not in wants:
                wants[mode] = timed_call(
                    torch, lambda: plain(mode, band, *args))
            want, ms_p = wants[mode]
            want = want[:5 if with_ptrs else 2]
            res = {path: banded_variant_check(torch, banded, mode, with_ptrs,
                                              band, args, want, sh)
                   for path, sh in shapes.items()}
            variant = f"{mode}/ptrs" if with_ptrs else mode
            emit({"phase": "banded", "level": "paths", "variant": variant,
                  "shape": shape, "warp_ms": res["warp"][2],
                  "cta_ms": res["cta"][2], "plain_ms": ms_p,
                  "warp_shape": list(shapes["warp"]),
                  "cta_shape": list(shapes["cta"]),
                  "bit_equal": res["warp"][0] and res["cta"][0],
                  "max_abs_err": max(res["warp"][1], res["cta"][1]),
                  "tolerance": TOL, "path_now": shapes["warp"][0]})
            for path, (equal, err, _) in res.items():
                check(equal and err == 0.0, f"banded {variant} at {shape}, "
                      f"{path} path: kernel != plain")
        del args, wants
    torch.cuda.empty_cache()


def similar_pairs(P, seed):
    """BS: long reads against their consensus. m ~ lognormal(median 2,000,
    sigma 0.2) random bases; the target is the query with 1% substitutions
    and 0.5% single-base indels (half insertions, half deletions)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for m in np.exp(rng.normal(np.log(2000), 0.2, P)).astype(int):
        q = alpha[rng.integers(0, 4, m)]
        t = q.copy()
        sub = rng.random(m) < 0.01
        t[sub] = alpha[rng.integers(0, 4, int(sub.sum()))]
        at = np.flatnonzero(rng.random(m) < 0.005)
        ins = rng.random(len(at)) < 0.5
        copies = np.ones(m, int)
        copies[at[~ins]] = 0
        copies[at[ins]] = 2
        t = np.repeat(t, copies)
        # an inserted base follows its position's own
        t[(np.cumsum(copies) - 1)[at[ins]]] = alpha[
            rng.integers(0, 4, int(ins.sum()))]
        pairs.append((q.tobytes(), t.tobytes()))
    return pairs


def banded_slab_checks(torch, tb, ebanded, banded, mode, pairs, params,
                       walk_rows=None, slab_rows=None, check_every=1,
                       band=BS_BAND, level="BS-slab", walk=True):
    """Kernel vs plain on every ``check_every``-th slab (the first always)
    the BS runs (BW's at ``band``, without the walk check: ``walk``) of
    ``mode`` fill: one plain
    call a slab holds the pointer-emitting fill of the rows run (every byte)
    and the score fill of the scores run (best and edge) where both fill it
    (the pointer budget cuts no slab at BS's size), and the walk is held
    against plain on the rows run's first slab, timed into ``walk_rows``
    when given. The kernel is timed on the first rows slab and the first
    scores slab (`slab_ms`, warm median of three) into ``slab_rows``."""
    from aligntools_tpu_torch import batch
    from aligntools_tpu_torch.convert import params_matrix

    dev = torch.device("cuda")
    pm = params_matrix(params, dev)
    budget = int(batch._hbm_budget(dev) * batch.PTR_BUDGET_FRAC)
    score_plan = ebanded.plan(pairs, band)
    rows_plan = (ebanded.plan(pairs, band, budget) if mode != "edit"
                 else [])
    slabs = ([(sl, True, sl in score_plan) for sl in rows_plan]
             + [(sl, False, True) for sl in score_plan
                if sl not in rows_plan])[::check_every]
    shapes, worst, walks, timed = [], 0.0, 0, set()
    for (idx, m_pad), rows, scores in slabs:
        s = ebanded._slab(idx, pairs, m_pad)
        qs, te, ns, ms = ebanded._slab_tensors(s, band, dev)
        args = (mode, band, qs, te, ns, ms, pm)
        shape = f"{len(idx)}x{m_pad}/W{band}"
        got = banded.banded_full(*args) if rows else ()
        got_s = banded.banded_scores(*args) if scores else ()
        torch.cuda.synchronize()
        want, ms_p = timed_call(torch, lambda: (
            banded.banded_full_plain(*args) if rows
            else banded.banded_scores_plain(*args)))
        equal = all(torch.equal(g, w) for g, w in zip(got, want))
        equal &= all(torch.equal(g, w) for g, w in zip(got_s, want))
        err = max([max_err(torch, g, w) for g, w in zip(got[:4], want)]
                  + [max_err(torch, g, w) for g, w in zip(got_s, want)])
        check(equal and err == 0.0, f"banded {mode} on BS slab {shape}: "
              f"kernel != plain")
        for kind, fn in (("rows", banded.banded_full),
                         ("scores", banded.banded_scores)):
            if slab_rows is None or kind in timed or not (
                    rows if kind == "rows" else scores):
                continue
            timed.add(kind)
            slab_rows.append(slab_row(torch, banded, fn, kind, args, shape,
                                      s, ms_p, err, level))
        del want, got_s
        if walk and rows and not walks:
            starts = tb.walk_starts(mode, got[0], got[2], got[3], ms, ns)
            w_k = tb.walk(mode, 1, got[4], qs, te, starts, band)
            torch.cuda.synchronize()
            w_p, w_plain = timed_call(torch, lambda: tb.walk_plain(
                mode, 1, got[4], qs, te, starts, band))
            w_eq = all(torch.equal(k, p) for k, p in zip(w_k, w_p))
            w_err = max([max_err(torch, w_k[2], w_p[2])]
                        + [0.0 if torch.equal(k, p) else float("inf")
                           for k, p in zip(w_k[:2], w_p[:2])])
            if walk_rows is not None:
                walk_rows.append(walk_row(
                    torch, tb, mode, 1, f"{mode}/banded", f"{shape}/BS",
                    got[4], qs, te, starts, w_k, w_eq, w_err, w_plain,
                    band))
            walks += 1
            equal, err = equal and w_eq, max(err, w_err)
            del w_k, w_p
        check(equal and err == 0.0, f"banded {mode} on BS slab {shape}: "
              f"kernel != plain")
        shapes.append(shape + ("/rows" if rows else "")
                      + ("/scores" if scores else ""))
        worst = max(worst, err)
        del got, qs, te, ns, ms
    torch.cuda.empty_cache()
    row = {"phase": "buckets", "path": "banded", "variant": mode,
           "buckets": len(shapes), "shapes": shapes, "walks_checked": walks,
           "bit_equal": True, "max_abs_err": worst, "tolerance": TOL}
    emit(row)
    return row


def slab_row(torch, banded, fn, kind, args, shape, slab, plain_ms, err,
             level="BS-slab"):
    """A BS (BW) slab's kernel timing (warm median of three) beside its
    bound:
    the counted ops over the band's cells inside the matrices, and the
    bytes of the inputs and outputs."""
    mode, band, qs, te, ns, ms, pm = args
    ms_k = statistics.median(timed_ms(torch, lambda: fn(*args))
                             for _ in range(3))
    B, m_pad = qs.shape
    ptrs = kind == "rows"
    need = band_cells(slab.m.tolist(), slab.n.tolist(), band)
    ops = (SCORE_OPS[mode] + (PTR_EXTRA_OPS[mode] if ptrs else 0)) * need
    in_bytes = sum(x.numel() * x.element_size() for x in (qs, te, ns, ms, pm))
    out_bytes = 8 * B + (8 * B + B * m_pad * banded.lanes_padded(band)
                         if ptrs else 0)
    b_ms, b_by = bound(ops, in_bytes + out_bytes)
    path, threads, strip = banded.launch_shape(band)
    V = 2 * band + 1
    row = {"phase": "banded", "level": level,
           "variant": f"{mode}/ptrs" if ptrs else mode, "shape": shape,
           "route": f"{path} {threads} threads", "strip": strip,
           "max_abs_err": err, "tolerance": TOL, "ms": ms_k,
           "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
           "probe_ms": probe_ms(ops, mode == "edit"),
           "band_cells": B * m_pad * V, "band_cells_in_matrix": need,
           "gcups_band": B * m_pad * V / ms_k / 1e6}
    emit(row)
    return row


def phase_banded(torch, scan, ptr, tb, work, trace_path):
    """BS: the banded path through cli.main, its launches counted from 0,
    then every slab against plain while the CPU runs of the samples go
    on."""
    import numpy as np

    from aligntools_tpu_torch import cli
    from aligntools_tpu_torch.engine import banded as ebanded
    from aligntools_tpu_torch.ops import banded
    from aligntools_tpu_torch.params import AlignParams

    pairs = similar_pairs(BS_PAIRS, SEED)
    small = pairs[:BS_SMALL]
    rng = np.random.default_rng(SEED + 5)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    fit_pairs = [(q, t + alpha[rng.integers(0, 4, 64)].tobytes())
                 for q, t in small]
    fastas = {}
    for label, ps in (("big", pairs), ("small", small), ("fit", fit_pairs)):
        fastas[label] = os.path.join(work, f"bs-{label}.fa")
        write_fasta(fastas[label], ps)
    runs_in = {"local": ("big", pairs), "global": ("big", pairs),
               "overlap": ("small", small), "fit": ("fit", fit_pairs),
               "edit": ("small", small)}
    emit({"phase": "banded", "level": "BS", "pairs": len(pairs),
          "band": BS_BAND, "true_cells": sum(len(q) * len(t)
                                             for q, t in pairs),
          "band_cells_in_matrix": band_cells(
              [len(q) for q, _ in pairs], [len(t) for _, t in pairs],
              BS_BAND)})

    def run(mode, label, rows):
        fa, ps = runs_in[mode]
        tsv = os.path.join(work, f"bs-{mode}-{'rows' if rows else 'scores'}"
                                 f"-{label}.tsv")
        argv = ["batch", mode, fastas[fa], "--band", str(BS_BAND),
                *([] if rows else ["--scores-only"]), "--out", tsv]
        wall, report = run_cli(cli, argv)
        n_cells = sum(len(q) * len(t) for q, t in ps)
        emit({"phase": "banded", "level": "BS",
              "path": "rows" if rows else "scores", "mode": mode,
              "run": label, "pairs": len(ps), "seconds": wall,
              "pairs_per_s": len(ps) / wall,
              "true_gcups": n_cells / wall / 1e9, "counters": report})
        return tsv

    # the banded path: its launches start here
    reset_counts(scan, ptr, tb)
    rows_tsv, scores_tsv, cold = {}, {}, {}
    for mode in ("local", "global"):
        cold[mode] = run(mode, "cold", True)
        rows_tsv[mode] = run(mode, "warm", True)
        scores_tsv[mode] = run(mode, "warm", False)
    for mode in ("overlap", "fit"):
        rows_tsv[mode] = run(mode, "cold", True)
        scores_tsv[mode] = run(mode, "cold", False)
    scores_tsv["edit"] = rows_tsv["edit"] = run("edit", "cold", False)
    torch.cuda.synchronize()
    launches, plain = counts(scan, ptr, tb)
    emit({"phase": "banded", "level": "BS", "launches": launches,
          "plain_calls": plain})
    for name in ("banded", "walk"):
        check(launches[name] > 0,
              f"kernel {name} never launched on the banded path")
    check(not any(plain.values()), f"plain versions ran on the banded path: "
          f"{plain}")
    for mode in ("local", "global"):
        with open(cold[mode], "rb") as a, open(rows_tsv[mode], "rb") as b:
            check(a.read() == b.read(),
                  f"BS {mode}: cold and warm rows TSVs differ")
    if trace_path:
        root, ext = os.path.splitext(trace_path)
        phase_profile(torch, cli, ["batch", "local", fastas["big"], "--band",
                                   str(BS_BAND)], work,
                      f"{root}.banded{ext}")

    # the CPU runs of the sampled pairs go on beside the slab checks
    jobs = start_cpu_checks(work, [
        (f"bs-{mode}", mode, rows_tsv[mode], scores_tsv[mode],
         runs_in[mode][1], None,
         [sample(range(len(runs_in[mode][1])), SAMPLES)],
         ["--band", str(BS_BAND)]) for mode in rows_tsv])
    try:
        params = AlignParams()
        checked_buckets, walks, slabs = [], [], []
        for mode in runs_in:
            checked_buckets.append(banded_slab_checks(
                torch, tb, ebanded, banded, mode, runs_in[mode][1], params,
                walks if mode == "local" else None, slabs,
                BS_CHECK_EVERY if mode in ("local", "global") else 1))
        checked = finish_cpu_checks(jobs)
    finally:
        stop_cpu_checks(jobs)
    emit({"phase": "banded", "level": "BS",
          "rows_equal_scores": sorted(m for m in rows_tsv if m != "edit"),
          "cpu_checked": checked})
    return launches, checked_buckets + slabs, walks


def noisy_reads(P, seed):
    """BW: noisy long reads (the query) against their draft (the target).
    The draft: lognormal(median BW_MEDIAN, sigma BW_SIGMA) random bases;
    the read: the draft with BW_ERRORS' substitutions, deletions and
    insertions (5%, 3%, 1%: a net drift of ~200 bases over 10,000)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    sub, dele, ins = BW_ERRORS
    pairs = []
    for n in np.exp(rng.normal(np.log(BW_MEDIAN), BW_SIGMA, P)).astype(int):
        draft = alpha[rng.integers(0, 4, n)]
        read = draft.copy()
        hit = rng.random(n) < sub
        read[hit] = alpha[rng.integers(0, 4, int(hit.sum()))]
        copies = np.ones(n, int)
        copies[rng.random(n) < dele] = 0
        grow = (copies == 1) & (rng.random(n) < ins)
        copies[grow] = 2
        read = np.repeat(read, copies)
        # an inserted base follows its position's own
        read[(np.cumsum(copies) - 1)[grow]] = alpha[
            rng.integers(0, 4, int(grow.sum()))]
        pairs.append((read.tobytes(), draft.tobytes()))
    return pairs


def phase_banded_bw(torch, scan, ptr, tb, work):
    """BW: the CTA path on the main path, `batch local|global --band
    BW_BAND` rows and scores through cli.main on BW_PAIRS noisy long reads
    against their draft, the launches counted from 0 just before and read
    just after (the CTA path and the walk launched, no plain version, every
    fill on the CTA path); each rows TSV's score column equals its scores
    TSV; a local rows run with `--trace DIR` in a fresh process (its
    profiler sees the card from the start; one started late in this
    process has recorded no device activity), its TSV the rows run's, the
    device's busy share of its pipeline's seconds from the trace; then
    local's first slab, the pointer and the score fill against one plain
    call, the kernel timed on it (`BW-slab` lines: ms, bound, band-GCUPS);
    not the walk, whose plain version would walk ~20,000 steps a pair (the
    card tests hold the walk over rows this wide against plain)."""
    import re

    from aligntools_tpu_torch import cli
    from aligntools_tpu_torch.engine import banded as ebanded
    from aligntools_tpu_torch.ops import banded
    from aligntools_tpu_torch.params import AlignParams

    pairs = noisy_reads(BW_PAIRS, SEED + 13)
    fasta = os.path.join(work, "bw.fa")
    write_fasta(fasta, pairs)
    ms, ns = [len(q) for q, _ in pairs], [len(t) for _, t in pairs]
    emit({"phase": "banded", "level": "BW", "pairs": len(pairs),
          "band": BW_BAND, "m_median": statistics.median(ms),
          "net_drift_median": statistics.median(
              n - m for m, n in zip(ms, ns)),
          "cta_shape": list(banded.cta_shape(BW_BAND)),
          "true_cells": sum(m * n for m, n in zip(ms, ns)),
          "band_cells_in_matrix": band_cells(ms, ns, BW_BAND)})
    tsv = {}
    reset_counts(scan, ptr, tb)
    for mode in ("local", "global"):
        for rows in (True, False):
            tsv[mode, rows] = os.path.join(
                work, f"bw-{mode}-{'rows' if rows else 'scores'}.tsv")
            argv = ["batch", mode, fasta, "--band", str(BW_BAND),
                    *([] if rows else ["--scores-only"]), "--out",
                    tsv[mode, rows]]
            wall, report = run_cli(cli, argv)
            emit({"phase": "banded", "level": "BW",
                  "path": "rows" if rows else "scores", "mode": mode,
                  "pairs": len(pairs), "seconds": wall,
                  "pairs_per_s": len(pairs) / wall,
                  "band_gcups": band_cells(ms, ns, BW_BAND) / wall / 1e9,
                  "counters": report})
    torch.cuda.synchronize()
    launches, plain = counts(scan, ptr, tb)
    emit({"phase": "banded", "level": "BW", "launches": launches,
          "plain_calls": plain})
    for name in ("banded_cta", "walk"):
        check(launches[name] > 0, f"kernel {name} never launched on BW")
    check(launches["banded"] == launches["banded_cta"],
          f"BW: {launches['banded'] - launches['banded_cta']} banded fills "
          f"off the CTA path")
    check(not any(plain.values()), f"plain versions ran on BW: {plain}")
    for mode in ("local", "global"):
        rows_match_scores(f"bw-{mode}", tsv[mode, True], tsv[mode, False],
                          pairs)
    trace_dir, traced = os.path.join(work, "bw-trace"), os.path.join(
        work, "bw-traced.tsv")
    run = subprocess.run(
        [sys.executable, "-m", "aligntools_tpu_torch", "batch", "local",
         fasta, "--band", str(BW_BAND), "--trace", trace_dir, "--out",
         traced], cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(run.returncode == 0, f"BW traced run exited {run.returncode}: "
          f"{run.stderr[-2000:]}")
    with open(traced, "rb") as a, open(tsv["local", True], "rb") as b:
        check(a.read() == b.read(), "BW: the traced rows TSV differs")
    report = [ln for ln in run.stderr.splitlines() if "Gcells in" in ln]
    seconds = float(re.search(r"Gcells in ([0-9.]+)s", report[-1]).group(1))
    spans = trace_overlap(os.path.join(trace_dir, "trace.json"))
    emit({"phase": "banded", "level": "BW", "path": "rows", "mode": "local",
          "run": "trace", "pipeline_s": seconds,
          "device_busy_ms": spans["busy_ms"],
          "busy_share": spans["busy_ms"] / 1000 / seconds,
          "walk": {k: v for k, v in spans.items() if k != "busy_ms"},
          "counters": report[-1]})
    check(spans["busy_ms"] > 0, "BW: the trace holds no device activity")
    slabs = []
    checked = banded_slab_checks(torch, tb, ebanded, banded, "local", pairs,
                                 AlignParams(), None, slabs, 1 << 30,
                                 BW_BAND, "BW-slab", walk=False)
    return launches, [checked] + slabs


def uncapped_reads(P, seed):
    """BU: reads of 200-400 random bases, 5% of them set to A, near the
    end of targets of random bases (40,000 - m - up to 200 before the read,
    500 after): a diagonal offset of ~40,000 - m, inside a band of
    BU_BAND."""
    import numpy as np

    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    pairs = []
    for _ in range(P):
        m = int(rng.integers(200, 401))
        q = alpha[rng.integers(0, 4, m)]
        r = q.copy()
        r[rng.random(m) < 0.05] = ord("A")
        t = np.concatenate([alpha[rng.integers(0, 4, 40000 - m - int(
            rng.integers(0, 200)))], r, alpha[rng.integers(0, 4, 500)]])
        pairs.append((q.tobytes(), t.tobytes()))
    return pairs


def start_banded_uncapped(work):
    """BU's reference: the port's `batch local --band BU_BAND --device cpu`
    on the BU reads in a process of four threads, started before BS so
    that it runs beside BS and BW. Returns (pairs, FASTA, the CPU TSV, the
    job)."""
    pairs = uncapped_reads(BU_PAIRS, SEED + 17)
    fasta = os.path.join(work, "bu.fa")
    write_fasta(fasta, pairs)
    out = os.path.join(work, "bu.cpu.tsv")
    cmd = [sys.executable, "-m", "aligntools_tpu_torch", "batch", "local",
           fasta, "--band", str(BU_BAND), "--device", "cpu", "--out", out]
    job = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.DEVNULL,
                           stderr=subprocess.PIPE, text=True,
                           env=dict(os.environ, OMP_NUM_THREADS="4"))
    return pairs, fasta, out, job


def phase_banded_uncapped(torch, scan, ptr, tb, work, started):
    """BU: the CTA path in chunks (past the kernel's one-pass width) on the
    main path. `batch local --band BU_BAND` through cli.main, cold then
    warm, the launches counted from 0 just before and read just after:
    every banded fill chunked, the walk launched, no plain version; both
    TSVs equal the `--device cpu` run's (``started`` before BS). Then
    banded_score_auto on an unrelated BU_AUTO local pair, counted alike:
    the band doubles from n - m + 16 to cover the matrix, two chunked
    fills; the score equals the unbanded route's on the card and
    (score, band, certified) the plain route's on the CPU. Returns the
    main path's launches."""
    import numpy as np

    from aligntools_tpu_torch import batch, cli
    from aligntools_tpu_torch.engine import banded as ebanded
    from aligntools_tpu_torch.ops import banded
    from aligntools_tpu_torch.params import AlignParams

    pairs, fasta, cpu_tsv, job = started
    ms, ns = [len(q) for q, _ in pairs], [len(t) for _, t in pairs]
    cells = band_cells(ms, ns, BU_BAND)
    emit({"phase": "banded", "level": "BU", "pairs": len(pairs),
          "band": BU_BAND, "chunks": banded.chunks(BU_BAND),
          "cta_shape": list(banded.cta_shape(BU_BAND)),
          "geometry": list(banded.cta_geometry(BU_BAND, *banded.cta_shape(
              BU_BAND)[1:])), "m": ms, "n": ns,
          "true_cells": sum(m * n for m, n in zip(ms, ns)),
          "band_cells_in_matrix": cells})
    tsv = {}
    try:
        reset_counts(scan, ptr, tb)
        for run in ("cold", "warm"):
            tsv[run] = os.path.join(work, f"bu-{run}.tsv")
            wall, report = run_cli(cli, ["batch", "local", fasta, "--band",
                                         str(BU_BAND), "--out", tsv[run]])
            emit({"phase": "banded", "level": "BU", "path": "rows",
                  "mode": "local", "run": run, "seconds": wall,
                  "pairs_per_s": len(pairs) / wall,
                  "band_gcups": cells / wall / 1e9, "counters": report})
        torch.cuda.synchronize()
        launches, plain = counts(scan, ptr, tb)
        emit({"phase": "banded", "level": "BU", "launches": launches,
              "plain_calls": plain})
        for name in ("banded_chunked", "walk"):
            check(launches[name] > 0, f"kernel {name} never launched on BU")
        check(launches["banded"] == launches["banded_chunked"],
              f"BU: {launches['banded'] - launches['banded_chunked']} "
              f"banded fills not in chunks")
        check(not any(plain.values()), f"plain versions ran on BU: {plain}")
        err = job.communicate(timeout=900)[1]
        check(job.returncode == 0, f"BU --device cpu exited "
              f"{job.returncode}: {err[-2000:]}")
    finally:
        stop_cpu_checks([(job,)])
    want = read_lines(cpu_tsv)
    check(len(want) == len(pairs), f"BU: {len(want)} CPU lines")
    for run in tsv:
        check(read_lines(tsv[run]) == want,
              f"BU: the card's {run} TSV differs from --device cpu's")

    rng = np.random.default_rng(SEED + 19)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    q, t = (alpha[rng.integers(0, 4, k)].tobytes() for k in BU_AUTO)
    reset_counts(scan, ptr, tb)
    t0 = time.perf_counter()
    got = ebanded.banded_score_auto("local", q, t, device="cuda")
    wall = time.perf_counter() - t0
    auto, plain = counts(scan, ptr, tb)
    unbanded = float(batch.batch_scores("local", [(q, t)], AlignParams(),
                                        device="cuda")[0])
    want = ebanded.banded_score_auto("local", q, t, device="cpu")
    emit({"phase": "banded", "level": "BU", "run": "auto", "mode": "local",
          "m": BU_AUTO[0], "n": BU_AUTO[1], "score": got[0],
          "band": got[1], "certified": got[2], "seconds": wall,
          "unbanded": unbanded, "plain_route": list(want),
          "launches": auto, "plain_calls": plain})
    check(auto["banded_chunked"] == auto["banded"] == 2,
          f"BU auto: {auto['banded']} fills, {auto['banded_chunked']} "
          f"chunked")
    check(not any(plain.values()), f"plain versions ran on BU auto: {plain}")
    check(got[2] and got[0] == unbanded,
          f"BU auto: {got} against the unbanded {unbanded}")
    check(got == want, f"BU auto: {got} against the plain route's {want}")
    return launches


@contextlib.contextmanager
def clocked(torch, targets, spans):
    """CUDA events around every call of each (module, function name) of
    ``targets``, kept as spans[name]; the functions are restored on exit."""
    saved = [(mod, name, getattr(mod, name)) for mod, name in targets]

    def timed(name, fn):
        def call(*args, **kw):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kw)
            end.record()
            spans.setdefault(name, []).append((start, end))
            return out
        return call

    for mod, name, fn in saved:
        setattr(mod, name, timed(name, fn))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def over_budget(batch, layout, mode, jump, q, t):
    """(an ALIGNTOOLS_HBM_BUDGET just below one pair's packed pointer bytes,
    so that its bucket's cap is 0; those bytes)."""
    m_pad, n_pad = batch._bucket_keys([(q, t)], 64, 128)[0]
    need = m_pad * n_pad // layout.rows_per_byte(mode, jump, m_pad)
    return int(need / batch.PTR_BUDGET_FRAC) - 64, need


def rescore_global(r1, r2, p):
    """The global score of two alignment rows, on the host: a column with
    no gap scores match or mismatch by byte equality; a run of k gap columns
    in one row costs o + e*(k-1), and o + e*k where it starts the alignment
    (the borders L(i, 0) = o + e*i and U(0, j) = o + e*j)."""
    import numpy as np

    a, b = np.frombuffer(r1, np.uint8), np.frombuffer(r2, np.uint8)
    gap = ord("-")
    kind = np.where(a == gap, 2, np.where(b == gap, 1, 0))  # 1 L, 2 U
    diag = kind == 0
    score = int(np.where(a[diag] == b[diag], p.match, p.mismatch).sum())
    g = kind != 0
    runs = int((g & np.concatenate([[True], kind[1:] != kind[:-1]])).sum())
    score += p.gap_open * runs + p.gap_extend * (int(g.sum()) - runs)
    if len(kind) and kind[0]:
        score += p.gap_extend
    return float(score)


def rescan_kernel_rows(torch, tb, mode, q, t, sites, S, params,
                       dtype=None, phase="rescan"):
    """The rescan's three instances against their plain versions on the
    card, at this pair's shapes and stride S as the main path gives them:
    the checkpoint forward, the refill of the row block the walk starts in,
    and the paused walk there, each timed (warm median of three) beside its
    bound and the plain version's one call. ``dtype`` float64: the double
    instances (kernels named with "64", bound at the FP64 rate)."""
    from aligntools_tpu_torch import layout
    from aligntools_tpu_torch.convert import params_matrix
    from aligntools_tpu_torch.engine import rescan, select
    from aligntools_tpu_torch.ops import blocked, ptr

    dev = torch.device("cuda")
    f64 = dtype == torch.float64
    jump = mode == "fit" and sites is not None
    variant = "fit+jump" if jump else mode
    (qs, ts, allow, ns, ms), m_pad, n_pad = rescan.pair_tensors(
        mode, q, t, sites, S, dev)
    pm = params_matrix(params, dev, torch.float64 if f64 else torch.float32)
    c_blk = select.blocked_c_blk(f64)
    rpb = layout.rows_per_byte(mode, jump, S)
    m, n = len(q), len(t)
    val = 8 if f64 else 4  # bytes a value
    rows = []

    def row(kernel, fn, got, plain, ops, nbytes, **extra):
        if f64 and kernel != "walk_pause":
            kernel += "64"
        ms_k = statistics.median(timed_ms(torch, fn) for _ in range(3))
        want, ms_p = timed_call(torch, plain)
        eq = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        b_ms, b_by = bound(ops, nbytes, f64 and kernel != "walk_pause")
        rows.append({"phase": phase, "kernel": kernel, "variant": variant,
                     "shape": f"{m}x{n}/S{S}", "bit_equal": eq,
                     "max_abs_err": err, "tolerance": TOL, "ms": ms_k,
                     "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                     "probe_ms": probe_ms(ops, kernel == "walk_pause",
                                          f64 and kernel != "walk_pause"),
                     **extra})
        emit(rows[-1])
        check(eq and err == 0.0, f"{kernel} {variant} at {m}x{n}, S {S}: "
              f"kernel != plain")

    def ckpt():
        return blocked.blocked_ckpt_fill(mode, jump, S, m_pad, n_pad, c_blk,
                                         qs, ts, allow, ns, ms, pm)

    fwd = ckpt()
    row("blocked_ckpt", ckpt, fwd, lambda: ptr.ptr_fill_plain(
        mode, jump, m_pad, n_pad, qs, ts, allow, ns, ms, pm, stride=S),
        m * n * SCORE_OPS[variant],
        4 * (m_pad + 2 * n_pad) + val * fwd[3].numel() + 8 + val)
    # the row block the walk starts in, from the start cell
    state, i, j = tb.walk_starts(mode, *fwd[:3], ms, ns)[:, 0].tolist()
    k = max(i - 1, 0) // S
    ck = fwd[3][:, k].contiguous()
    q_blk = qs[:, k * S : (k + 1) * S]
    del fwd

    def refill():
        return blocked.blocked_refill(mode, jump, S, n_pad, c_blk, ck, k * S,
                                      q_blk, ts, allow, ns, ms, pm, rpb)

    ptrs = refill()
    row("blocked_refill", lambda: (refill(),), (ptrs,),
        lambda: (ptr.ptr_fill_plain(mode, jump, S, n_pad, q_blk, ts, allow,
                                    ns, ms, pm, rpb, seed=ck, i0=k * S),),
        S * n * (SCORE_OPS[variant] + PTR_EXTRA_OPS[variant]),
        val * ck.numel() + 4 * (S + 2 * n_pad) + ptrs.numel(), block=k)
    starts = torch.tensor([[state], [i - k * S], [j]], dtype=torch.int32,
                          device=dev)

    def walk():
        return tb.walk(mode, rpb, ptrs, q_blk, ts, starts, pause=True)

    got = walk()
    steps = int(got[2][0, 0])
    row("walk_pause", walk, got, lambda: tb.walk_plain(
        mode, rpb, ptrs, q_blk, ts, starts, pause=True),
        WALK_OPS_PER_STEP * steps, WALK_BYTES_PER_STEP * steps + 32,
        block=k, steps=steps, chain_ms=chain_ms(steps))
    return rows


def phase_rescan(torch, scan, ptr, tb):
    """The checkpoint-rescan route of the rows path. RSF: the route forced
    through batch.align_batch by an ALIGNTOOLS_HBM_BUDGET just below each
    pair's pointer bytes, the counts set to 0 just before and read just
    after, each pair's rows byte-equal to the normal route's at the true
    budget; then the route's three kernels against their plain versions at
    those pairs' shapes. RSR: a pair past the true budget."""
    from aligntools_tpu_torch import batch, layout
    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.utils.synth import related_pair

    params = AlignParams()
    dev = torch.device("cuda")
    cases = [("fit", *drawn_pair(*BLOCKED_B1[3:], SEED + 20, True))]
    q, t = related_pair(*RSF_SHAPE, SEED + 21)
    cases += [(mode, q, t, None) for mode in ("global", "local")]
    # overlap's alignment ends the query on the target's start (a dovetail):
    # the query is drawn from there
    cases.append(("overlap", *related_pair(*RSF_SHAPE, SEED + 21, offset=0),
                  None))
    normal = [batch.align_batch(mode, [(q, t)], params,
                                [s] if s else None, traceback=True,
                                device=dev)[0] for mode, q, t, s in cases]
    forced, plan = [], []
    reset_counts(scan, ptr, tb)
    for mode, q, t, s in cases:
        hbm, need = over_budget(batch, layout, mode, s is not None, q, t)
        budget = int(hbm * batch.PTR_BUDGET_FRAC)
        S = batch._auto_stride(len(q), batch.pad_len(len(t)), budget)
        plan.append((S, need, budget))
        os.environ["ALIGNTOOLS_HBM_BUDGET"] = str(hbm)
        try:
            forced.append(batch.align_batch(mode, [(q, t)], params,
                                            [s] if s else None,
                                            traceback=True, device=dev)[0])
        finally:
            del os.environ["ALIGNTOOLS_HBM_BUDGET"]
    torch.cuda.synchronize()
    launches, plain = counts(scan, ptr, tb)
    emit({"phase": "rescan", "level": "RSF", "launches": launches,
          "plain_calls": plain})
    for name in ("blocked_ckpt", "blocked_refill", "walk", "walk_pause"):
        check(launches[name] > 0,
              f"kernel {name} never launched on the forced rescan")
    check(launches["blocked_ckpt"] == len(cases) and launches["ptr"] == 0
          and launches["blocked_ptr"] == 0, f"the forced rescan took "
          f"another route: {launches}")
    check(not any(plain.values()), f"plain versions ran on the forced "
          f"rescan: {plain}")
    for (mode, q, t, s), want, got, (S, need, budget) in zip(
            cases, normal, forced, plan):
        same = (got.score, got.row1, got.row2) == (want.score, want.row1,
                                                   want.row2)
        emit({"phase": "rescan", "level": "RSF",
              "mode": mode + (" -s" if s else ""), "shape": f"{len(q)}x"
              f"{len(t)}", "stride": S, "blocks": -(-len(q) // S),
              "pointer_bytes": need, "budget": budget,
              "rows_equal_normal_route": same, "score": got.score})
        check(same, f"RSF {mode}: the rescan's rows differ from the normal "
              f"route's")
    rows = []
    for (mode, q, t, s), (S, _, _) in zip(cases, plan):
        rows += rescan_kernel_rows(torch, tb, mode, q, t, s, S, params)
    phase_rsr(torch, scan, ptr, tb)
    return launches, rows


def phase_rsr(torch, scan, ptr, tb):
    """RSR: global on a seeded related pair sized from the card's memory so
    that its packed pointers pass the true budget by RSR_OVER, aligned
    through batch.align_batch at that budget. No plain or CPU run is
    possible at this size: its score must be bit-equal to the score route's
    (the blocked score fill), its rows must rescore on the host to that
    score, and the rows without gaps must be the pair."""
    from aligntools_tpu_torch import batch, layout
    from aligntools_tpu_torch.engine import device_tb, rescan
    from aligntools_tpu_torch.ops import blocked
    from aligntools_tpu_torch.params import AlignParams
    from aligntools_tpu_torch.utils.synth import related_pair

    params = AlignParams()
    dev = torch.device("cuda")
    total = torch.cuda.mem_get_info(dev)[1]
    budget = int(batch._hbm_budget(dev) * batch.PTR_BUDGET_FRAC)
    m = 100000
    while (batch._align_m(m, 64) * batch._align_n(int(m * RSR_ASPECT), 128)
           // 2 < RSR_OVER * budget):
        m += 1000
    q, t = related_pair(m, int(m * RSR_ASPECT), SEED + 22)
    hbm, need = over_budget(batch, layout, "global", False, q, t)
    check(need > budget, f"RSR: {need} pointer bytes do not pass the "
          f"budget {budget}")
    S = batch._auto_stride(len(q), batch.pad_len(len(t)), budget)
    t0 = time.perf_counter()
    want = batch.align_batch("global", [(q, t)], params, device=dev)[0]
    score_wall = time.perf_counter() - t0
    reset_counts(scan, ptr, tb)
    torch.cuda.reset_peak_memory_stats(dev)
    spans = {}
    with clocked(torch, [(blocked, "blocked_ckpt_fill"),
                         (blocked, "blocked_refill"),
                         (device_tb, "walk")], spans):
        t0 = time.perf_counter()
        got = batch.align_batch("global", [(q, t)], params, traceback=True,
                                device=dev)[0]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    launches, plain = counts(scan, ptr, tb)
    ms = {name: [a.elapsed_time(b) for a, b in ev]
          for name, ev in spans.items()}
    blocks = len(ms["blocked_refill"])
    check(launches["blocked_ckpt"] == 1 and blocks == launches[
        "blocked_refill"] == launches["walk_pause"] > 0 and launches["ptr"]
          == launches["blocked_ptr"] == 0, f"RSR took another route: "
          f"{launches}")
    check(not any(plain.values()), f"plain versions ran on RSR: {plain}")
    rescored = rescore_global(got.row1, got.row2, params)
    gapless = (got.row1.replace(b"-", b""), got.row2.replace(b"-", b""))
    steps = len(got.row1)
    m, n = len(q), len(t)
    n_pad = rescan.pad_n(n)
    f_ops, r_ops = SCORE_OPS["global"], (SCORE_OPS["global"]
                                         + PTR_EXTRA_OPS["global"])
    rpb = layout.rows_per_byte("global", False, S)
    f_bound = bound(m * n * f_ops, 4 * (m + 2 * n) + 12 * (n_pad + 1)
                    * -(-m // S))
    r_bound = bound(blocks * S * n * r_ops, blocks * (12 * (n_pad + 1)
                    + 4 * S + S * n_pad // rpb))
    w_bound = bound(WALK_OPS_PER_STEP * steps, WALK_BYTES_PER_STEP * steps)
    row = {"phase": "rescan", "level": "RSR", "card": nvidia_smi_line(),
           "mode": "global", "shape": f"{m}x{n}", "pointer_bytes": need,
           "budget": budget, "device_memory": total, "stride": S,
           "blocks": blocks, "checkpoint_rows": -(-m // S),
           "forward_ms": ms["blocked_ckpt_fill"][0],
           "forward_bound_ms": f_bound[0], "forward_bound_by": f_bound[1],
           "refill_ms": sum(ms["blocked_refill"]),
           "refill_bound_ms": r_bound[0], "refill_bound_by": r_bound[1],
           "walk_ms": sum(ms["walk"]), "walk_bound_ms": w_bound[0],
           "walk_bound_by": w_bound[1], "walk_chain_ms": chain_ms(steps),
           "steps": steps, "wall_s": wall,
           "true_gcups": m * n / wall / 1e9,
           "score_route_wall_s": score_wall,
           "peak_memory_bytes": peak, "score": got.score,
           "score_equal_score_route": got.score == want.score,
           "rows_rescore_to_score": rescored == got.score,
           "rows_are_the_pair": gapless == (q, t)}
    emit(row)
    check(row["score_equal_score_route"], f"RSR: score {got.score} != the "
          f"score route's {want.score}")
    check(row["rows_rescore_to_score"], f"RSR: the rows rescore to "
          f"{rescored}, not {got.score}")
    check(row["rows_are_the_pair"], "RSR: the rows without gaps are not the "
          "pair")
    check(peak < total, f"RSR: peak memory {peak} past the card's {total}")
    return row


def phase_validate(torch):
    """The port's differential campaign (aligntools_tpu_torch.tools.
    validate) on the card: every section in this process at
    VALIDATE_N_PER against the native C++ CLI, with seqpar on loopback
    ranks; each section's cases, skips and seconds, and each kernel's
    launches over the phase (every kernel of VALIDATE_KERNELS launched, no
    plain version and no double instance ran)."""
    from aligntools_tpu_torch.tools import validate

    lines = []
    try:
        out = validate.run_sections(VALIDATE_N_PER, device="cuda",
                                    log=lines.append)
    except validate.Mismatch as err:
        check(False, f"validate: {err}")
    torch.cuda.synchronize()
    launches = out["launches"]
    emit({"phase": "validate", "n_per": VALIDATE_N_PER,
          "seconds": out["seconds"],
          "sections": out["sections"],
          "launches": launches, "lines": len(lines)})
    for name in VALIDATE_KERNELS:
        check(launches[name] > 0, f"validate: kernel {name} never launched")
    check(launches["plain"] == 0, f"validate: plain versions ran "
          f"{launches['plain']} times")
    check_no_double(launches, "the validate phase")
    return launches


def native_cli():
    """The native C++ CLI (``native/aligntools_cli.cpp``, which computes in
    double as the reference does), built from the checkout's sources into
    the port's build directory (``native.cli_binary``); a failed build
    fails the run."""
    from aligntools_tpu_torch import native

    try:
        return native.cli_binary()
    except RuntimeError as err:
        check(False, str(err)[-800:])


def exact64_rows(torch, ptr, scan, tb, params):
    """Every double instance against its float64 plain version on the
    card, bit for bit, and timed (warm median of three; the plain version's
    one call) beside its bound at the FP64 rate: the
    flat pointer fill at every (mode, rpb) of K1's inputs, edit's flat
    score fill there; at the B1 shape the blocked pointer fill (FILL,
    fit+jump), its CKPT and SEED phases and edit's blocked score fill."""
    from aligntools_tpu_torch.convert import params_matrix
    from aligntools_tpu_torch.engine import select
    from aligntools_tpu_torch.ops import blocked

    pm = params_matrix(params, "cuda", torch.float64)
    rows = []

    def row(kernel, variant, shape, fn, plain, ops, nbytes, **extra):
        got = fn()
        torch.cuda.synchronize()
        want, ms_p = timed_call(torch, plain)  # the plain version's one call
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        eq = all(torch.equal(g, w) for g, w in zip(got, want))
        err = max(max_err(torch, g, w) for g, w in zip(got, want))
        del got, want
        ms_k = statistics.median(timed_ms(torch, fn) for _ in range(3))
        b_ms, b_by = bound(ops, nbytes, True)
        rows.append({"phase": "exact64", "kernel": kernel,
                     "variant": variant, "shape": shape, "bit_equal": eq,
                     "max_abs_err": err, "tolerance": TOL, "ms": ms_k,
                     "plain_ms": ms_p, "bound_ms": b_ms, "bound_by": b_by,
                     "probe_ms": probe_ms(ops, f64=True), **extra})
        emit(rows[-1])
        check(eq and err == 0.0, f"{kernel} {variant} at {shape}: double "
              f"kernel != float64 plain")

    B, m_pad, n_pad, ragged, _ = SHAPES[0]
    args, cells = kernel_inputs(B, m_pad, n_pad, ragged, SEED, "cuda")
    qs, ts, allow, ns, ms, _ = args
    args = (qs, ts, allow, ns, ms, pm)
    shape = f"{B}x{m_pad}x{n_pad}"
    in_bytes = input_bytes(args, False)
    for mode, jump, rpb in PTR_SHAPES[0][4]:
        variant = mode + ("+jump" if jump else "")
        row("ptr64", f"{variant}/rpb{rpb}", shape,
            lambda: ptr.ptr_fill(mode, jump, m_pad, n_pad, qs, ts,
                                 allow if jump else None, ns, ms, pm, rpb),
            lambda: ptr.ptr_fill_plain(mode, jump, m_pad, n_pad, qs, ts,
                                       allow if jump else None, ns, ms, pm,
                                       rpb),
            (SCORE_OPS[variant] + PTR_EXTRA_OPS[variant]) * cells,
            in_bytes + B * m_pad // rpb * n_pad + 16 * B,
            route=ptr_route(ptr, n_pad, torch.float64)[1])
    row("edit64", "edit", shape,
        lambda: scan.scores("edit", m_pad, n_pad, qs, ts, ns, ms, pm),
        lambda: scan.scores_plain("edit", m_pad, n_pad, qs, ts, ns, ms, pm),
        SCORE_OPS["edit"] * cells, in_bytes + 8 * B,
        flat_shape=list(scan.flat_shape("edit", n_pad, torch.float64)))
    del args, qs, ts, allow, ns, ms
    B, m_pad, n_pad, m, n = BLOCKED_B1
    args, cells = kernel_inputs(B, m_pad, n_pad, False, SEED + 3, "cuda",
                                lengths=(m, n), sites=3)
    qs, ts, allow, ns, ms, _ = args
    args = (qs, ts, allow, ns, ms, pm)
    c_blk = select.blocked_c_blk(True)
    shape = f"{B}x{m_pad}x{n_pad}"
    row("blocked_ptr64", "fit+jump/rpb1", shape,
        lambda: blocked.blocked_ptr_fill("fit", True, m_pad, n_pad, c_blk,
                                         qs, ts, allow, ns, ms, pm, 1),
        lambda: ptr.ptr_fill_plain("fit", True, m_pad, n_pad, qs, ts, allow,
                                   ns, ms, pm, 1),
        (SCORE_OPS["fit+jump"] + PTR_EXTRA_OPS["fit+jump"]) * cells,
        input_bytes(args, True) + m_pad * n_pad + 16, c_blk=c_blk)
    row("blocked_edit64", "edit", shape,
        lambda: blocked.blocked_scores("edit", False, m_pad, n_pad, c_blk,
                                       qs, ts, None, ns, ms, pm),
        lambda: scan.scores_plain("edit", m_pad, n_pad, qs, ts, ns, ms, pm),
        SCORE_OPS["edit"] * cells, input_bytes(args, False) + 8,
        c_blk=c_blk)
    del args, qs, ts, allow, ns, ms
    torch.cuda.empty_cache()
    q, t, sites = drawn_pair(*BLOCKED_B1[3:], SEED + 20, True)
    rows += rescan_kernel_rows(torch, tb, "fit", q, t, sites, EXACT64_STRIDE,
                               params, torch.float64, phase="exact64")
    return rows


def phase_exact64(torch, scan, ptr, tb, work):
    """Single pairs past float32's exact integers on the double instances.
    The main path: the per-mode commands (``MODE -m ... FILE`` through
    cli.main in-process on the card) at EXACT64_OPTS on a seeded 2,048^2
    pair a mode, a global pair past the double pointer fill's cap (the
    blocked fill) and an edit pair past the double edit fill's, and one
    global pair through the checkpoint rescan under ALIGNTOOLS_HBM_BUDGET
    (as RSF), the counts set to 0 just before and read just after: every
    double instance, the walk and the paused walk launched, no float32
    instance and no plain version; every stdout byte for byte the native C++
    CLI's (which computes in double). The batch path still refuses such a
    pair. Then the instances' registers and spills and every instance
    against its plain version (exact64_rows)."""
    from aligntools_tpu_torch import batch, cli, layout
    from aligntools_tpu_torch.ops import _build
    from aligntools_tpu_torch.params import AlignParams

    kw = dict(zip(("match", "mismatch", "gap_open", "gap_extend"),
                  (int(v) for v in EXACT64_OPTS[1::2])))
    params = AlignParams(**kw, jump=EXACT64_JUMP)
    runs = []
    for k, mode in enumerate(SINGLE_MODES):
        q, t, _ = drawn_pair(SINGLE_N, SINGLE_N, SEED + 40 + k)
        runs.append((f"{mode}-{SINGLE_N}", mode, q, t))
    for k, (mode, m, n) in enumerate(EXACT64_WIDE):
        q, t, _ = drawn_pair(m, n, SEED + 50 + k)
        runs.append((f"{mode}-{m}x{n}", mode, q, t))
    argvs = {}
    for label, mode, q, t in runs:
        path = os.path.join(work, f"exact64-{label}.fa")
        write_fasta(path, [(q, t)])
        argvs[label] = [mode, *EXACT64_OPTS, path]
    # the rescan: global on the wide pair, a budget just below its pointers
    r_label, r_mode, r_q, r_t = runs[len(SINGLE_MODES)]
    hbm, need = over_budget(batch, layout, r_mode, False, r_q, r_t)
    reset_counts(scan, ptr, tb)
    card = {label: run_single(cli, argv, None)[0]
            for label, argv in argvs.items()}
    os.environ["ALIGNTOOLS_HBM_BUDGET"] = str(hbm)
    try:
        rescanned = run_single(cli, argvs[r_label], None)[0]
    finally:
        del os.environ["ALIGNTOOLS_HBM_BUDGET"]
    torch.cuda.synchronize()
    launches, plain = counts(scan, ptr, tb)
    emit({"phase": "exact64", "runs": len(argvs) + 1, "opts": EXACT64_OPTS,
          "launches": launches, "plain_calls": plain,
          "rescan": {"pair": r_label, "pointer_bytes": need,
                     "hbm_budget": hbm}})
    for name in ("ptr64", "edit64", "blocked_ptr64", "blocked_edit64",
                 "blocked_ckpt64", "blocked_refill64", "walk", "walk_pause"):
        check(launches[name] > 0,
              f"kernel {name} never launched on the double route")
    single = {k: v for k, v in launches.items() if not k.endswith("64")
              and k not in ("walk", "walk_pause") and v}
    check(not single, f"float32 instances launched on the double route: "
          f"{single}")
    check(not any(plain.values()), f"plain versions ran on the double "
          f"route: {plain}")
    native = native_cli()
    for label, argv in argvs.items():
        r = subprocess.run([native, *argv], capture_output=True, text=True,
                           timeout=600)
        check(r.returncode == 0, f"native {label} exited {r.returncode}")
        check(card[label] == r.stdout, f"exact64 {label}: the card's stdout "
              f"differs from the native C++ CLI's")
    check(rescanned == card[r_label], "exact64: the rescan's stdout differs "
          "from the normal route's")
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        rc = cli.main(["batch", "global", argvs[runs[0][0]][-1],
                       *EXACT64_OPTS, "--out", os.path.join(work, "x.tsv")])
    check(rc == 255 and "exact-integer range" in err.getvalue(),
          f"exact64: batch did not refuse the pair (exit {rc})")
    emit({"phase": "exact64", "stdout_equal_native": sorted(argvs),
          "rescan_equal_normal_route": True, "batch_refuses": True})
    usage = [r for r in resource_usage(_build.library_path(), (
        "ptr_affine_kernel", "ptr_overlap_kernel", "edit_score_kernel",
        "bptr_affine", "bptr_overlap", "bscore_edit"))
        if "double" in r["kernel"] or "EdE" in r["kernel"]]
    emit({"phase": "exact64", "resource_usage": usage})
    check(usage, "cuobjdump listed no double instance")
    return launches, exact64_rows(torch, ptr, scan, tb, params)


def s2_l3_sample():
    """The calibrate phase's sample: every CAL_S2_EVERY-th of S2's pairs
    (with their junction sites) and the CAL_L3_PAIRS shortest-target of
    L3's, as phase_slice and phase_long draw them; and CAL_BS_PAIRS of BS's
    similar pairs."""
    import numpy as np

    from aligntools_tpu_torch.utils.synth import clustered_pairs

    small = clustered_pairs(20000, seed=SEED)[:2000]
    rng = np.random.default_rng(SEED)
    sites = [sorted(int(x) for x in rng.integers(0, len(t), 3))
             for _, t in small]
    s2 = (small[::CAL_S2_EVERY], sites[::CAL_S2_EVERY])
    pairs, lsites = long_pairs(LONG_PAIRS, SEED + 1)
    order = sorted(range(len(pairs)), key=lambda k: len(pairs[k][1]))
    take = order[:CAL_L3_PAIRS]
    l3 = ([pairs[k] for k in take], [lsites[k] for k in take])
    return s2, l3, similar_pairs(CAL_BS_PAIRS, SEED + 3)


def phase_calibrate(torch):
    """``engine/autotune.calibrate(force=True)`` into a temporary
    ALIGNTOOLS_TORCH_CACHE (the machine keeps no table), its table and
    timings; then a sample of S2's, L3's and BS's pairs (rows and scores)
    under the measured table and under CAL_MOVED, which moves every key
    off its default, each byte-equal to the default route's."""
    from aligntools_tpu_torch import batch
    from aligntools_tpu_torch.engine import autotune
    from aligntools_tpu_torch.engine import banded as ebanded
    from aligntools_tpu_torch.params import AlignParams

    was_env = os.environ.get(autotune.CACHE_ENV)
    lines = []
    with tempfile.TemporaryDirectory() as cache:
        os.environ[autotune.CACHE_ENV] = cache
        try:
            t0 = time.perf_counter()
            table = autotune.calibrate(force=True, log=lines.append)
            seconds = time.perf_counter() - t0
            written = os.listdir(cache)
        finally:
            if was_env is None:
                del os.environ[autotune.CACHE_ENV]
            else:
                os.environ[autotune.CACHE_ENV] = was_env
            autotune.set_table(None)
    emit({"phase": "calibrate", "seconds": seconds, "written": written,
          "table": {k: table[k] for k in autotune.DEFAULTS},
          "measured": table.get("measured"), "log": lines})
    check(written and seconds < CAL_SECONDS, f"calibrate: {seconds:.1f} s, "
          f"wrote {written}")
    s2, l3, bs = s2_l3_sample()
    params = AlignParams()
    runs = [("S2 global rows", "global", s2[0], None, True),
            ("S2 fit -s rows", "fit", s2[0], s2[1], True),
            ("S2 overlap scores", "overlap", s2[0], None, False),
            ("S2 edit scores", "edit", s2[0], None, False),
            ("L3 fit -s rows", "fit", l3[0], l3[1], True),
            ("L3 fit -s scores", "fit", l3[0], l3[1], False),
            ("L3 local rows", "local", l3[0], None, True)]

    def results(t):
        autotune.set_table(t)
        try:
            out = {label: [r if isinstance(r, int) else
                           (r.score, r.row1, r.row2) for r in
                           batch.align_batch(mode, pairs, params, sites,
                                             traceback=rows, device="cuda")]
                   for label, mode, pairs, sites, rows in runs}
            for mode in ("local", "global"):
                out[f"BS {mode} rows"] = [
                    (r.score, r.row1, r.row2) for r in
                    ebanded.banded_align_batch(mode, bs, BS_BAND, params,
                                               device="cuda")[0]]
            torch.cuda.synchronize()
            return out
        finally:
            autotune.set_table(None)

    calibrate_bs_band(torch, table)
    default = results(dict(autotune.DEFAULTS))
    for name, t in (("measured", table), ("moved", CAL_MOVED)):
        got = results(t)
        same = {label: got[label] == default[label] for label in default}
        emit({"phase": "calibrate", "table": name, "equal_default": same,
              "pairs": {label: len(v) for label, v in default.items()}})
        check(all(same.values()), f"calibrate: the {name} table changed a "
              f"result: {same}")
    return table


def calibrate_bs_band(torch, table):
    """The banded kernel at BS's band (local, pointers) at each batch of
    CAL_BS_BATCHES, through the path select.banded_path picks under the
    defaults and under the measured ``table``: warm medians of CAL_TURNS
    turns (default, measured, measured, default), each table's path named
    beside its time."""
    from aligntools_tpu_torch.engine import autotune, select
    from aligntools_tpu_torch.ops import banded

    tables = {"default": dict(autotune.DEFAULTS), "measured": table}
    for B in CAL_BS_BATCHES:
        args = banded_kernel_inputs(torch, B, CAL_BS_L, BS_BAND, SEED + 9)
        paths, times = {}, {name: [] for name in tables}
        try:
            for name in tables:
                autotune.set_table(tables[name])
                paths[name] = select.banded_path(BS_BAND, B)
                banded._launch("local", True, BS_BAND, *args)  # warm
            for _ in range(CAL_TURNS):
                for name in ("default", "measured", "measured", "default"):
                    autotune.set_table(tables[name])
                    times[name].append(timed_ms(torch, lambda: banded._launch(
                        "local", True, BS_BAND, *args)))
        finally:
            autotune.set_table(None)
        emit({"phase": "calibrate", "level": "BS-band", "variant":
              "local/ptrs", "shape": f"{B}x{CAL_BS_L}/W{BS_BAND}",
              **{f"{name}_path": paths[name] for name in tables},
              **{f"{name}_ms": sorted(t)[len(t) // 2]
                 for name, t in times.items()}})
        del args
    torch.cuda.empty_cache()


PROFILE_GROUPS = (("fill", ("ptr_affine", "ptr_overlap", "bptr_",
                            "banded_")),
                  ("walk", ("walk_kernel",)),
                  ("copies", ("Memcpy", "memcpy")),
                  ("allocation", ("Memset", "memset", "FillFunctor")))


def sms_in_use(trace_path, n_sm):
    """Per group of PROFILE_GROUPS, the SMs that hold a CTA of its kernels,
    min(n_sm, the grid's CTAs), weighted by each launch's device time in
    the Chrome trace; None where the trace gives no grid."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    acc = {name: [0.0, 0.0] for name, _ in PROFILE_GROUPS}
    for ev in events:
        grid = (ev.get("args") or {}).get("grid")
        if ev.get("cat") != "kernel" or not grid:
            continue
        group = next((name for name, keys in PROFILE_GROUPS
                      if any(k in ev.get("name", "") for k in keys)), None)
        if group is not None:
            ctas = grid[0] * grid[1] * grid[2]
            acc[group][0] += ev.get("dur", 0) * min(n_sm, ctas)
            acc[group][1] += ev.get("dur", 0)
    return {name: (sm_us / us if us else None)
            for name, (sm_us, us) in acc.items()}


def merged(spans):
    """Sorted, disjoint cover of the (start, end) ``spans``."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def trace_overlap(trace_path):
    """From the Chrome trace: the device's busy time, the union of its
    kernels', copies' and sets' spans (the fill and the walk run at once on
    two streams), the walk's time, and how much of it ran while a fill
    kernel ran; in ms."""
    with open(trace_path) as f:
        events = json.load(f).get("traceEvents", [])
    spans = {"fill": [], "walk": [], "device": []}
    for ev in events:
        if ev.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        span = (ev["ts"], ev["ts"] + ev.get("dur", 0))
        spans["device"].append(span)
        for name, keys in PROFILE_GROUPS[:2]:
            if ev["cat"] == "kernel" and any(k in ev.get("name", "")
                                             for k in keys):
                spans[name].append(span)
    fills = merged(spans["fill"])
    under = sum(max(0.0, min(b, d) - max(a, c))
                for a, b in spans["walk"] for c, d in fills)
    walk = sum(b - a for a, b in spans["walk"])
    busy = sum(b - a for a, b in merged(spans["device"]))
    return {"busy_ms": busy / 1e3, "walk_ms": walk / 1e3,
            "walk_share_of_busy": walk / busy if busy else None,
            "walk_under_fill_ms": under / 1e3,
            "walk_under_fill_share": under / walk if walk else None}


def device_ops(prof):
    """The device's time per op of a torch.profiler run, longest first."""
    ops = []
    for ev in prof.key_averages():
        if "CUDA" not in str(ev.device_type):
            continue
        ms = ev.device_time_total / 1000
        if ms > 0:
            ops.append({"op": ev.key[:80], "calls": ev.count, "ms": ms})
    ops.sort(key=lambda o: -o["ms"])
    return ops


def phase_profile(torch, cli, argv, work, trace_path):
    """One more warm rows run (``argv``, the CLI's) under torch.profiler:
    device time per op (CUDA kernels and copies) against the run's wall
    clock, and from the trace the busy time and the walk's overlap with
    the fills (``trace_overlap``)."""
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(os.path.dirname(trace_path), exist_ok=True)
    tsv = os.path.join(work, "profiled.tsv")
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall, report = run_cli(cli, [*argv, "--out", tsv])
        torch.cuda.synchronize()
    ops = device_ops(prof)
    busy = sum(o["ms"] for o in ops)
    split = {name: 0.0 for name, _ in PROFILE_GROUPS}
    split["other"] = 0.0
    for o in ops:
        group = next((name for name, keys in PROFILE_GROUPS
                      if any(k in o["op"] for k in keys)), "other")
        split[group] += o["ms"]
    prof.export_chrome_trace(trace_path)
    spans = trace_overlap(trace_path)
    emit({"phase": "profile", "run": " ".join(argv[1:2] + argv[3:]),
          "path": "rows",
          "wall_s": wall, "device_busy_ms": spans["busy_ms"],
          "busy_share": spans["busy_ms"] / 1000 / wall,
          "device_time_ms": busy, "split_ms": split,
          "walk": {k: v for k, v in spans.items() if k != "busy_ms"},
          "sms_in_use": sms_in_use(
              trace_path, torch.cuda.get_device_properties(0)
              .multi_processor_count),
          "counters": report, "device_ops": ops[:12], "trace": trace_path})
    check(busy > 0, "torch.profiler recorded no device time")


def summary(rows, ptr_rows, walk_rows, bucket_rows, launches, blocked_rows,
            long_buckets, banded_rows, banded_buckets, probe_reps,
            rescan_rows, exact64_rows, par_rows, bw_rows, bu_launches):
    """The kernels line: each kernel's representative timing, its launches
    on its path's main-path run, and its largest error over every check.
    ``banded_cta`` also carries BKW's widest shapes (local pointers: one
    pass at W 32,767 and the chunked widths) and BU's chunked launches."""
    from aligntools_tpu_torch.engine import select

    c_blk_own = select.blocked_c_blk()

    out = []
    for name, (replaces, src, variants) in KERNELS.items():
        if name in probe_reps:
            timed = mine = [probe_reps[name]]
        elif name in ("edge_scores", "edge_ptr", "walk_col_pause"):
            # the representative timing: fit+jump (edge_scores), global
            # (the pointer fill and the walk)
            mine = [r for r in par_rows if r["kernel"] == name]
            timed = [r for r in mine if r["variant"] in (
                "fit+jump", "global/rpb2")] or mine
        elif name.endswith("64"):
            # the representative timing: K1's local rpb 2 for the flat
            # pointer fill; each other instance's one shape
            mine = [r for r in exact64_rows if r["kernel"] == name]
            timed = [r for r in mine if r["variant"] == "local/rpb2"] or mine
        elif name == "banded":
            # the representative timing: BK1's local pointers at W = 128;
            # the main path's own shape, the first rows slab of BS local
            # (--band 128), stands beside it
            timed = [r for r in banded_rows if r["level"] != "BKW"]
            mine = timed + banded_buckets
            timed = [r for r in timed if r["variant"] == "local/ptrs"]
            slab = next(r for r in banded_buckets if r.get("level")
                        == "BS-slab" and r["variant"] == "local/ptrs")
        elif name == "banded_cta":
            # the representative timing: BKW's local pointers at W 1,000;
            # the first rows slab of BW local (--band 512) beside it
            mine = [r for r in banded_rows if r["level"] == "BKW"] + bw_rows
            timed = [r for r in mine if r.get("level") == "BKW" and r[
                "variant"] == "local/ptrs" and "/W1000" in r["shape"]]
            slab = next(r for r in bw_rows if r.get("level") == "BW-slab"
                        and r["variant"] == "local/ptrs")
        elif name in ("blocked_ckpt", "blocked_refill", "walk_pause"):
            # the representative timing: RSF's global pair at S 256
            mine = [r for r in rescan_rows if r["kernel"] == name]
            timed = [r for r in mine if r["variant"] == "global"]
        elif name.startswith("blocked"):
            # the representative timing: L2, the fixture's shape
            timed = [r for r in blocked_rows if r["kernel"] == name]
            path = "scores" if name == "blocked_scores" else "rows"
            mine = timed + [r for r in long_buckets if r["path"] == path]
            timed = [r for r in timed if r["level"] == "L2"
                     and r["c_blk"] == c_blk_own]
        elif name == "ptr":
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
        # shape's last variant (the probe's: its float32 row)
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
            "probe_ms": rep["probe_ms"], "library_ms": None,
            "variant": rep["variant"], "shape": rep["shape"],
            **({"chain_ms": rep["chain_ms"]} if "chain_ms" in rep else {}),
            **({"bs_slab" if name == "banded" else "bw_slab": {
                k: slab[k] for k in ("shape", "ms", "plain_ms", "bound_ms",
                                     "bound_by")}}
               if name in ("banded", "banded_cta") else {}),
            **({"wide": {
                "bu_chunked_launches": bu_launches["banded_chunked"],
                "bkw": [{k: r[k] for k in ("shape", "ms", "plain_ms",
                                           "bound_ms", "bound_by")}
                        for r in mine if r.get("level") == "BKW"
                        and r["variant"] == "local/ptrs" and any(
                            w in r["shape"] + "/" for w in BKW_WIDE)]}}
               if name == "banded_cta" else {}),
        })
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description="Smoke run of the PyTorch / "
                                             "CUDA port on one GPU")
    # one rank of the parallel phase's gloo group (the script spawns them)
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--store", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--profile", metavar="TRACE.json", default=None,
                    help="also profile one warm 20,000-pair rows local run, "
                         "one warm long-target fit -s rows run and one warm "
                         "banded local rows run, and write their Chrome "
                         "traces here (the second and third with .long and "
                         ".banded before the extension)")
    ap.add_argument("--only", choices=("bkw",), default=None,
                    help="run the device and probe phases and the banded "
                         "phase's BKW level alone (the CTA path at "
                         "BANDED_BKW, with the banded instances' registers): "
                         "from a copy of this script in another commit's "
                         "checkout, that commit's kernels")
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
    if opts.rank is not None:
        return rank_main(opts)
    from aligntools_tpu_torch import native
    from aligntools_tpu_torch.backend import resolve_device
    from aligntools_tpu_torch.engine import device_tb as tb
    from aligntools_tpu_torch.ops import _build, ptr, scan
    from aligntools_tpu_torch.engine import autotune
    from aligntools_tpu_torch.tools import vpu_probe

    pinned = tempfile.TemporaryDirectory()
    os.environ[autotune.CACHE_ENV] = pinned.name
    autotune.set_table(None)
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

    probe_launches, probe_reps = phase_probe(torch, vpu_probe, _build)
    if opts.only == "bkw":
        from aligntools_tpu_torch.ops import banded

        emit({"phase": "banded", "resource_usage": resource_usage(
            _build.library_path(), ("banded_",))})
        phase_banded_wide(torch, banded)
        print(smi, flush=True)
        return 0
    rows = phase_kernels(torch, scan)
    ptr_rows, walk_rows = phase_ptr(torch, ptr, tb)
    phase_walk_cases(torch, tb)
    blocked_rows = phase_blocked(torch, scan, ptr)
    from aligntools_tpu_torch.ops import banded

    banded_rows = phase_banded_kernels(torch, banded)
    trace = opts.profile and os.path.abspath(opts.profile)
    os.makedirs(_build.BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as work:
        launches, bucket_rows, slice_out = phase_slice(torch, scan, ptr, tb,
                                                       work, trace)
        phase_single(torch, scan, ptr, tb, work)
        phase_serve(torch, scan, ptr, tb, slice_out)
        par_launches, par_rows = phase_parallel(torch, scan, ptr, tb, work,
                                                slice_out)
        long_launches, long_buckets, long_walks = phase_long(
            torch, scan, ptr, tb, work, trace)
        rescan_launches, rescan_rows = phase_rescan(torch, scan, ptr, tb)
        phase_validate(torch)
        exact64_launches, exact64_rows = phase_exact64(torch, scan, ptr, tb,
                                                       work)
        bu_started = start_banded_uncapped(work)
        try:
            banded_launches, banded_buckets, banded_walks = phase_banded(
                torch, scan, ptr, tb, work, trace)
            bw_launches, bw_rows = phase_banded_bw(torch, scan, ptr, tb,
                                                   work)
            bu_launches = phase_banded_uncapped(torch, scan, ptr, tb, work,
                                                bu_started)
        finally:
            stop_cpu_checks([(bu_started[3],)])
    phase_calibrate(torch)
    import torch.distributed as dist

    if dist.is_initialized():  # the parallel phase's one-rank NCCL group
        dist.destroy_process_group()
    launches.update(blocked_scores=long_launches["blocked_scores"],
                    blocked_ptr=long_launches["blocked_ptr"],
                    banded=banded_launches["banded"],
                    banded_cta=bw_launches["banded_cta"], **probe_launches,
                    **{k: rescan_launches[k] for k in (
                        "blocked_ckpt", "blocked_refill", "walk_pause")},
                    **{k: exact64_launches[k] for k in KERNELS
                       if k.endswith("64")},
                    **{k: par_launches[k] for k in ("edge_scores", "edge_ptr",
                                                    "walk_col_pause")})
    emit({"kernels": summary(rows, ptr_rows,
                             walk_rows + long_walks + banded_walks,
                             bucket_rows, launches, blocked_rows,
                             long_buckets, banded_rows, banded_buckets,
                             probe_reps, rescan_rows, exact64_rows,
                             par_rows, bw_rows, bu_launches)})
    pinned.cleanup()
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

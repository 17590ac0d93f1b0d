"""The port's crossover table (``engine/autotune.py``) and the routes that
read it (``engine/select.py``), on the CPU.

Defaults without a cache (today's constants); a cache read by the card's
slug (the card's name monkeypatched); an out-of-range value ignored with
one stderr line; the crossover choices as pure functions of synthetic
timings; results equal with and without an injected table (every route is
bit-equal, so a table moves time alone); ``calibrate`` off the card."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import json
import os

import numpy as np
import pytest
import torch

from aligntools_tpu_torch import batch as tbatch
from aligntools_tpu_torch.engine import autotune, select
from aligntools_tpu_torch.ops import banded, blocked, ptr, scan
from aligntools_tpu_torch.params import AlignParams

KIND = "NVIDIA H100 80GB HBM3"
# a valid table that moves every key off its default
MOVED = {"score_flat_cap": {"affine": 256, "overlap": 128, "edit": 384},
         "ptr_flat_cap": {"float32": 256, "float64": 128},
         "blocked_c_blk": 1024,
         "banded_bmin": {"5": 100000, "9": 100000, "16": 100000}}


@pytest.fixture(autouse=True)
def fresh_table(monkeypatch, tmp_path):
    """Each test reads its own cache directory and starts with no active
    table; the one active before is put back after."""
    monkeypatch.setenv(autotune.CACHE_ENV, str(tmp_path))
    monkeypatch.delenv(select.CBLK_ENV, raising=False)
    was = autotune.set_table(None)
    yield
    autotune.set_table(was)


def _routed(t):
    return {k: t[k] for k in autotune.DEFAULTS}


def test_defaults_without_a_card_or_cache(monkeypatch):
    """No card (or no cache): the defaults, which are the routes' constants
    before the table existed."""
    monkeypatch.setattr(autotune, "device_kind", lambda: None)
    assert _routed(autotune.table()) == autotune.DEFAULTS
    assert select.score_flat_cap("global") == ptr.FLAT_REG_MAX_N_PAD
    assert select.score_flat_cap("fit") == 8192
    assert select.score_flat_cap("overlap") == 8192
    assert select.score_flat_cap("edit") == scan.EDIT_MAX_THREADS * ptr.WIDTH
    assert select.ptr_flat_cap() == ptr.FLAT_REG_MAX_N_PAD
    assert select.ptr_flat_cap(True) == ptr.FLAT64_MAX_N_PAD == 4096
    assert select.blocked_c_blk() == autotune.DEFAULTS["blocked_c_blk"] == 2048
    assert select.banded_path(128, 1) == "warp"
    assert select.banded_path(256, 10 ** 6) == "cta"


def test_defaults_with_a_card_and_no_cache(monkeypatch, tmp_path):
    monkeypatch.setattr(autotune, "device_kind", lambda: KIND)
    assert not os.path.exists(autotune.cache_path(KIND))
    assert _routed(autotune.table()) == autotune.DEFAULTS


def test_cache_is_read_by_the_cards_slug(monkeypatch, tmp_path):
    path = autotune.cache_path(KIND)
    assert path == str(tmp_path / "autotune_NVIDIA_H100_80GB_HBM3.json")
    with open(path, "w") as f:
        json.dump({"device_kind": KIND, **MOVED, "measured": {"x": 1}}, f)
    monkeypatch.setattr(autotune, "device_kind", lambda: KIND)
    t = autotune.table()
    assert _routed(t) == MOVED and t["measured"] == {"x": 1}
    assert select.score_flat_cap("local") == 256
    assert select.score_flat_cap("edit") == 384
    assert select.ptr_flat_cap(True) == 128
    assert select.blocked_c_blk() == 1024
    assert select.banded_path(128, 64) == "cta"
    assert select.banded_path(128, 100000) == "warp"
    assert ptr.blocked_c_blk(384) == 1024
    assert scan.blocked_c_blk("edit", 384) is None
    assert scan.blocked_c_blk("edit", 512) == 1024
    # another card's name reads another file: the defaults here
    monkeypatch.setattr(autotune, "device_kind", lambda: "NVIDIA H200")
    autotune.set_table(None)
    assert _routed(autotune.table()) == autotune.DEFAULTS


@pytest.mark.parametrize("key,value", [
    ("ptr_flat_cap.float32", 8320),  # past threads_max x W
    ("ptr_flat_cap.float64", 8192),  # past the double instance's 4,096
    ("score_flat_cap.edit", 1000),  # off the 128-column grid
    ("score_flat_cap.affine", 0),
    ("blocked_c_blk", 3072),  # does not divide 16,384
    ("blocked_c_blk", 16384),  # past C_BLK_MAX
    ("banded_bmin", -1),  # a number where a table of strips is due
    ("banded_bmin", "64"),
    ("banded_bmin.16", -1),
    ("banded_bmin.9", "64"),
    ("score_flat_cap", 4096),
])
def test_out_of_range_value_is_ignored_with_a_line(monkeypatch, capsys, key,
                                                   value):
    head, _, leaf = key.partition(".")
    raw = {head: {leaf: value} if leaf else value, "blocked_c_blk": 4096}
    if head == "blocked_c_blk":
        raw = {head: value}
    with open(autotune.cache_path(KIND), "w") as f:
        json.dump(raw, f)
    monkeypatch.setattr(autotune, "device_kind", lambda: KIND)
    t = autotune.table()
    err = capsys.readouterr().err.splitlines()
    assert len(err) == 1 and "ignored" in err[0] and key in err[0]
    want = json.loads(json.dumps(autotune.DEFAULTS))
    if head != "blocked_c_blk":
        want["blocked_c_blk"] = 4096  # the valid value beside it is read
    assert _routed(t) == want
    with pytest.raises(ValueError, match="refused"):
        autotune.set_table({head: {leaf: value} if leaf else value})


def test_unreadable_cache_is_ignored(monkeypatch, capsys):
    with open(autotune.cache_path(KIND), "w") as f:
        f.write("{not json")
    monkeypatch.setattr(autotune, "device_kind", lambda: KIND)
    assert _routed(autotune.table()) == autotune.DEFAULTS
    assert "ignored" in capsys.readouterr().err


def test_blocked_cblk_env_comes_first(monkeypatch, capsys):
    """ALIGNTOOLS_BLOCKED_CBLK as the JAX select reads it (at least 128),
    before the table; a value no kernel takes is ignored with a line. The
    double instances take at most C_BLK_MAX64."""
    autotune.set_table(MOVED)
    monkeypatch.setenv(select.CBLK_ENV, "8192")
    assert select.blocked_c_blk() == 8192
    assert select.blocked_c_blk(True) == blocked.C_BLK_MAX64 == 4096
    monkeypatch.setenv(select.CBLK_ENV, "16")
    assert select.blocked_c_blk() == 128
    monkeypatch.setenv(select.CBLK_ENV, "3000")
    assert select.blocked_c_blk() == 1024
    assert "ALIGNTOOLS_BLOCKED_CBLK" in capsys.readouterr().err


@pytest.mark.parametrize("timings,want", [
    ({4224: (1, 2), 6144: (1, 2), 8192: (1, 2)}, 8192),
    ({4224: (1, 2), 6144: (3, 2), 8192: (1, 2)}, 4224),  # no gap in the wins
    ({4224: (3, 2), 6144: (1, 2), 8192: (1, 2)}, 4096),  # loses at once
    ({4224: (2, 2), 6144: (2, 2)}, 6144),  # a tie keeps the flat fill
])
def test_flat_cap_from_synthetic_timings(timings, want):
    assert autotune.flat_cap_from(timings) == want


@pytest.mark.parametrize("timings,want", [
    ({64: (1, 2), 256: (1, 2), 1024: (1, 2), 2112: (1, 2)}, 0),
    ({64: (3, 2), 256: (3, 2), 1024: (1, 2), 2112: (1, 2)}, 1024),
    ({64: (1, 2), 256: (3, 2), 1024: (1, 2), 2112: (1, 2)}, 1024),
    ({64: (3, 2), 256: (3, 2), 1024: (3, 2), 2112: (3, 2)}, 2113),
])
def test_bmin_from_synthetic_timings(timings, want):
    assert autotune.bmin_from(timings) == want


def test_fastest_from_synthetic_timings():
    assert autotune.fastest({1024: 3.0, 2048: 2.0, 4096: 2.5}) == 2048
    assert autotune.fastest({1024: 2.0, 8192: 2.0}) == 1024


@pytest.mark.parametrize("choice,timings,want", [
    # flat loses at 8,192 by 0.05 with a spread of 0.1: the cap stays
    ("cap", {4224: (1, 2, 0.1), 8192: (2.05, 2, 0.1)}, 8192),
    ("cap", {4224: (1, 2, 0.1), 8192: (2.2, 2, 0.1)}, 4224),
    ("cap", {4224: (2.2, 2, 0.1), 8192: (1, 2, 0.1)}, 4096),
    # the CTA path wins at 64 pairs inside the spread, then past it
    ("bmin", {64: (1.1, 1.0, 0.2), 256: (1, 2, 0.1)}, 0),
    ("bmin", {64: (1.5, 1.0, 0.2), 256: (1, 2, 0.1)}, 256),
    # 1,024 beats the default 2,048 by 3% inside the ranges summed
    ("c_blk", {1024: (0.97, 0.02), 2048: (1.0, 0.02), 4096: (0.99, 0.0)},
     2048),
    ("c_blk", {1024: (0.90, 0.02), 2048: (1.0, 0.02), 4096: (0.99, 0.0)},
     1024),
])
def test_choices_keep_the_default_within_the_spread(choice, timings, want):
    """A key moves off its default only where the alternative wins by more
    than the spread measured at that point."""
    fn = {"cap": autotune.flat_cap_from, "bmin": autotune.bmin_from,
          "c_blk": lambda t: autotune.fastest(t, 2048)}[choice]
    assert fn(timings) == want


def test_problem_names_each_structural_range():
    assert select.problem("score_flat_cap.edit", 16384) is None
    assert select.problem("score_flat_cap.edit", 16512)
    assert select.problem("score_flat_cap.overlap", 8192) is None
    assert select.problem("ptr_flat_cap.float64", 4096) is None
    assert select.problem("ptr_flat_cap.float16", 128)
    for c_blk in (16, 128, 1024, 8192):
        assert select.problem("blocked_c_blk", c_blk) is None, c_blk
    assert select.problem("banded_bmin.16", 0) is None
    assert select.problem("banded_bmin.5", 10 ** 6) is None
    assert select.problem("banded_bmin.7", 0)  # not a warp strip
    assert select.problem("banded_bmin", 0)  # a table of strips is due
    assert select.problem("nmax", 4096)  # not ported: not a key
    assert select.problem("blocked_c_blk", True)


def test_banded_path_reads_the_threshold():
    """Each band reads the threshold of its own warp strip: one set for
    strip 16 (W 200) leaves W 128 (strip 9) and W 64 (strip 5) on the warp
    path; past the widest strip the CTA path at any batch."""
    autotune.set_table({"banded_bmin": {"16": 256}})
    assert select.banded_path(200, 255) == "cta"
    assert select.banded_path(200, 256) == "warp"
    assert select.banded_path(128, 64) == "warp"
    assert select.banded_path(64, 1) == "warp"
    assert select.banded_path(256, 10 ** 6) == "cta"
    assert banded.cta_shape(200) == ("cta", 256, 4)  # two teams of four
    assert banded.launch_shape(200) == ("warp", 128, 16)
    autotune.set_table({"banded_bmin": {"9": 64}})
    assert select.banded_path(128, 63) == "cta"
    assert select.banded_path(143, 63) == "cta"  # strip 9's widest band
    assert select.banded_path(144, 63) == "warp"  # strip 16's narrowest
    assert select.banded_path(79, 63) == "warp"  # strip 5's widest


def test_calibrate_times_one_band_of_each_warp_strip():
    """calibrate's bands: one a warp strip, on that strip, and the table's
    banded_bmin keyed by the same strips."""
    assert set(autotune.BANDED_BANDS) == set(autotune.DEFAULTS["banded_bmin"])
    assert set(autotune.BANDED_BANDS) == {str(s) for s in banded.WARP_STRIPS}
    for strip, band in autotune.BANDED_BANDS.items():
        assert banded.launch_shape(band) == ("warp", 128, int(strip)), band


def _pairs(P, seed):
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(b"ACGT", np.uint8)
    out = []
    for _ in range(P):
        m = int(rng.integers(20, 120))
        n = int(rng.integers(m, 700))
        q = alpha[rng.integers(0, 4, m)]
        t = np.concatenate([q, alpha[rng.integers(0, 4, n - m)]])
        out.append((q.tobytes(), t.tobytes()))
    return out


def _key(r):
    return r if isinstance(r, int) else (r.score, r.row1, r.row2)


@pytest.mark.parametrize("mode", ["global", "local", "fit", "overlap",
                                  "edit"])
def test_results_equal_with_and_without_a_table(mode):
    """Scores and rows of a batch whose buckets cross every moved cap are
    the same under the defaults and under MOVED; so is a single pair past
    float32's range (the double route's caps)."""
    pairs = _pairs(6, 17)
    sites = [[5, 40, 300]] * len(pairs) if mode == "fit" else None
    big = AlignParams(match=1048573, mismatch=-1048571, gap_open=-3145739,
                      gap_extend=-1048577, jump=-2097143)
    from aligntools_tpu_torch import api

    out = []
    for t in (dict(autotune.DEFAULTS), MOVED):
        autotune.set_table(t)
        blocked.reset_counts()
        rows = tbatch.align_batch(mode, pairs, AlignParams(), sites,
                                  traceback=mode != "edit", device="cpu")
        one = api.align_pair(mode, *pairs[1], big, device="cpu")
        out.append(([_key(r) for r in rows], _key(one),
                    blocked.plain_calls))
    assert out[0][:2] == out[1][:2]
    assert out[0][2] < out[1][2]  # MOVED sends more buckets to the blocked


def test_banded_results_equal_with_and_without_a_table():
    from aligntools_tpu_torch.engine import banded as ebanded

    pairs = [(q, q[:5] + b"A" + q[5:]) for q, _ in _pairs(4, 23)]
    got = []
    for t in (dict(autotune.DEFAULTS), MOVED):
        autotune.set_table(t)
        got.append([_key(r) for r in ebanded.banded_align_batch(
            "global", pairs, 16, AlignParams(), device="cpu")[0]])
    assert got[0] == got[1]


def test_calibrate_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        autotune.calibrate(force=True)
    assert os.listdir(tmp_path) == []


def test_calibrate_command_without_a_card_is_fatal(monkeypatch, capsys,
                                                   tmp_path):
    """``aligntools-torch calibrate`` off the card: FATAL ERROR, exit 255,
    nothing on stdout and no table written."""
    from aligntools_tpu_torch.cli import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main(["calibrate"]) == 255
    cap = capsys.readouterr()
    assert cap.out == "" and cap.err.startswith("FATAL ERROR: ")
    assert os.listdir(tmp_path) == []

"""``aligntools_tpu_torch.tools.validate``, the port's differential campaign,
on the CPU (the kernels' plain versions) against the native C++ CLI.

Every section passes at a small n_per (``routes`` under a small crossover
table, so that short pairs cross many column blocks); an injected wrong
score or row fails the campaign, which names the section, mode and case;
the campaign's copies draw and return what ``tools/validate.py``'s do; on
the campaign's own cases the native CLI agrees with the JAX spec engine
(the oracle tied to the JAX package); ``native.cli_binary`` builds, reuses
and refuses."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import dataclasses
import importlib.util
import os
import subprocess

import numpy as np
import pytest

from aligntools_tpu_torch import api, batch, native
from aligntools_tpu_torch.engine import autotune, rescan
from aligntools_tpu_torch.params import AlignResult
from aligntools_tpu_torch.tools import validate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PER = 5
# caps of one quantum and a 32-column block: routes' widths are 128 and 256
SMALL_TABLE = {"score_flat_cap": {"affine": 128, "overlap": 128,
                                  "edit": 128},
               "ptr_flat_cap": {"float32": 128, "float64": 128},
               "blocked_c_blk": 32}


@pytest.fixture
def small_table():
    was = autotune.set_table(SMALL_TABLE)
    try:
        yield
    finally:
        autotune.set_table(was)


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_validate_tool", os.path.join(REPO, "tools", "validate.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("section", list(validate.SECTIONS))
def test_section_passes_on_cpu(request, section, capsys):
    if section == "routes":
        request.getfixturevalue("small_table")
        assert validate.route_widths("global") == [128, 256]
    out = validate.run_sections(N_PER, [section], "cpu")
    stats = out["sections"][section]
    assert stats["cases"] > 0 and stats["oracle_rc"] == 0
    assert out["launches"]["plain"] > 0  # the plain versions ran
    assert not any(v for k, v in out["launches"].items() if k != "plain")
    lines = capsys.readouterr().out.splitlines()
    modes = validate.ROWS_MODES if section in ("rescan", "banded-full",
                                               "seqpar") else validate.MODES
    assert {ln.split(":")[0] for ln in lines} == {
        f"{section} {m}" for m in modes}
    assert all(ln.split(": ")[1].startswith("OK") for ln in lines)


def _nth(n, flip):
    """A wrapper factory: the n-th call (from 0) of the wrapped function
    whose first argument is "global" returns ``flip`` of its result."""
    calls = []

    def wrap(fn):
        def inner(mode, *a, **kw):
            r = fn(mode, *a, **kw)
            if mode == "global":
                calls.append(1)
                if len(calls) == n + 1:
                    return flip(r)
            return r
        return inner
    return wrap


def _plus_one(r):
    return AlignResult(r.score + 1, r.row1, r.row2)


def _row_byte(r):
    r1 = bytes([r.row1[0] ^ 1]) + r.row1[1:]
    return AlignResult(r.score, r1, r.row2)


def _pair_plus_one(scores):
    out = np.array(scores, copy=True)
    out[1] += 1
    return out


# (section, module, attribute, the wrapper, the case it names)
FAULTS = [
    ("main", api, "align_pair", _nth(2, _plus_one), "global case 2"),
    ("native-cli", api, "align_file",
     _nth(1, lambda rp: (_row_byte(rp[0]), rp[1])), "global case 1"),
    ("rescan", rescan, "rescan_align", _nth(1, _row_byte), "global case 1"),
    ("routes", batch, "batch_scores", _nth(0, _pair_plus_one),
     "global case 1"),
]


@pytest.mark.parametrize("section,mod,attr,wrap,where", FAULTS,
                         ids=[f[0] for f in FAULTS])
def test_injected_fault_fails_the_campaign(request, monkeypatch, capsys,
                                           section, mod, attr, wrap, where):
    if section == "routes":
        request.getfixturevalue("small_table")
    monkeypatch.setattr(mod, attr, wrap(getattr(mod, attr)))
    rc = validate.main([str(N_PER), "--device", "cpu", "--section", section])
    cap = capsys.readouterr()
    assert rc == 1
    assert f"VALIDATION FAILED: Mismatch: [{section}] {where} (seed " \
        f"{validate.SEEDS[section]}, m=" in cap.err
    assert "params m=" in cap.err
    assert not any(ln.startswith("{") for ln in cap.out.splitlines())


def test_port_error_names_its_case(monkeypatch):
    def broken(*a, **kw):
        raise RuntimeError("walk hit unset pointer")

    monkeypatch.setattr(rescan, "rescan_align", broken)
    with pytest.raises(validate.Mismatch,
                       match=r"\[rescan\] global case 0 .*RuntimeError: walk "
                             r"hit unset pointer"):
        validate.run_sections(N_PER, ["rescan"], "cpu")


def test_copies_agree_with_the_jax_tool(tmp_path):
    jt = _jax_tool()
    assert validate.PARAM_SETS == jt.PARAM_SETS
    assert validate.KINDS == jt.KINDS
    for kind in jt.KINDS:
        a, b = np.random.default_rng(5), np.random.default_rng(5)
        for lo, hi in ((1, 1), (1, 40), (17, 300)):
            assert validate.gen_seq(a, kind, lo, hi) == jt.gen_seq(b, kind,
                                                                   lo, hi)
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    for mode in validate.MODES:
        for kw in ({}, {"max_m": 60, "max_n": 120}, {"sites_ok": False}):
            a, b = np.random.default_rng(11), np.random.default_rng(11)
            for k in range(12):
                got = validate.gen_case(a, mode, k, str(tmp_path / "port"),
                                        **kw)
                want = jt.gen_case(b, mode, k, str(tmp_path / "jax"), **kw)
                assert got[:2] == want[:2] and got[3] == want[3]
                assert dataclasses.asdict(got[2]) == dataclasses.asdict(
                    want[2])
                assert got[5][:-1] == want[5][:-1]
                with open(got[4]) as f, open(want[4]) as g:
                    assert f.read() == g.read()
    rows = [("AC-GT", "ACGGT", "ACGT", "ACGGT"), ("AC", "A", "AC", "A"),
            ("A-C", "AGC", "AC", "TAGCT"), ("AC", "AC", "GAC", "TACG"),
            ("AT", "AC", "AT", "AC")]
    for r1, r2, q, t in rows:
        for mode in validate.ROWS_MODES:
            assert validate.rows_sane(r1, r2, q, t, mode) == jt.rows_sane(
                r1, r2, q, t, mode)
    outs = {"global": ["score=3.000000", "AC-GT", "ACGGT"],
            "fit": ["1|2", "score=-1.000000", "AC", "AG"],
            "overlap": ["2.000000", "AC", "AC"],
            "edit": ["edit_distance=7"]}
    for mode, lines in outs.items():
        assert validate.ref_score_rows(lines, mode) == jt.ref_score_rows(
            lines, mode)


def test_oracle_agrees_with_the_jax_spec_engine(tmp_path):
    """The native CLI's scores and rows equal the JAX spec engine's on the
    main section's own cases (the reference checkout is absent here)."""
    from aligntools_tpu.params import AlignParams as JaxParams
    from aligntools_tpu.spec import engine as spec

    oracle = validate.Oracle(native.cli_binary())
    rng = np.random.default_rng(validate.SEEDS["main"])
    sane = 0
    for mode in validate.MODES:
        for k in range(8):
            q, t, p, sites, _, cmd = validate.gen_case(rng, mode, k,
                                                       str(tmp_path))
            lines, rc, _ = oracle(cmd)
            assert rc == 0, (mode, k)
            score, r1, r2 = validate.ref_score_rows(lines, mode)
            jp = JaxParams(**dataclasses.asdict(p))
            if mode == "edit":
                assert score == spec.spec_edit(q, t, jp), (mode, k)
                continue
            w = (spec.spec_fit(q, t, jp, sites) if mode == "fit"
                 else getattr(spec, f"spec_{mode}")(q, t, jp))
            assert score == w.score, (mode, k)
            if validate.rows_sane(r1, r2, q.decode(), t.decode(), mode):
                sane += 1
                assert (r1, r2) == (w.row1.decode(), w.row2.decode()), (
                    mode, k)
    assert sane == 32


def test_cli_binary_builds_reuses_and_refuses(tmp_path, monkeypatch):
    assert os.path.dirname(native.cli_path()) == native.BUILD_DIR
    assert native.BUILD_DIR == os.path.join(REPO, "aligntools_tpu_torch",
                                            "_build")
    before = sorted(os.listdir(os.path.join(REPO, "native")))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    path = native.cli_binary()
    assert os.path.dirname(path) == str(tmp_path / "build")
    assert os.access(path, os.X_OK)
    r = subprocess.run([path, "global", os.path.join(REPO, "test",
                                                     "test_global.fa")],
                       capture_output=True, text=True, timeout=60)
    assert r.returncode == 0 and r.stdout.startswith("score=")
    assert sorted(os.listdir(os.path.join(REPO, "native"))) == before

    def no_compile(*a, **kw):
        raise AssertionError("rebuilt with unchanged sources")

    monkeypatch.setattr(native.subprocess, "run", no_compile)
    assert native.cli_binary() == path
    monkeypatch.undo()

    bad = tmp_path / "bad.cpp"
    bad.write_text("int main() { return undeclared_name; }\n")
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "CLI_SOURCES", (str(bad),))
    assert native.cli_path() != path  # the digest covers the sources
    with pytest.raises(RuntimeError, match="undeclared_name"):
        native.cli_binary()
    assert not os.path.exists(native.cli_path())

"""``aligntools-torch global|local|fit|overlap|edit FILE`` and
``api.align_pair``: the port's single-pair entry points on the CPU
(``ALIGNTOOLS_DEVICE=cpu``), held against the JAX package.

The per-mode CLI against ``aligntools_tpu.cli.main`` in-process (its spec
route): stdout, the ``FATAL ERROR`` line and the exit code, byte for byte,
but for the port's stated departure (empty sides follow the JAX device
route); pairs past float32's exact integers run the port's double
instances and print the JAX CLI's bytes. ``align_pair`` against
``aligntools_tpu.engine.scan.scan_align`` field by field."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import os
import subprocess
import sys

import numpy as np
import pytest

from aligntools_tpu.api import align_pair as jax_align_pair
from aligntools_tpu.cli import main as jax_main
from aligntools_tpu.engine.scan import scan_align
from aligntools_tpu.params import AlignParams as JaxParams
from aligntools_tpu_torch import api
from aligntools_tpu_torch.cli import main
from aligntools_tpu_torch.io.fasta import read_pair
from aligntools_tpu_torch.params import AlignParams

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TEST = os.path.join(REPO, "test")
MODES = ("global", "local", "fit", "overlap", "edit")
ALPHABETS = {"dna": b"ACGT", "binary": b"AC"}


@pytest.fixture(autouse=True)
def on_cpu(monkeypatch):
    monkeypatch.setenv("ALIGNTOOLS_DEVICE", "cpu")


def _fatal(err):
    return [ln for ln in err.splitlines() if ln.startswith("FATAL ERROR")]


def _port(capsys, *args):
    rc = main(list(args))
    cap = capsys.readouterr()
    return cap.out, _fatal(cap.err), rc


def _jax(capsys, *args):
    rc = jax_main(["aligntools", *args])
    cap = capsys.readouterr()
    return cap.out, _fatal(cap.err), rc


def _same(capsys, *args):
    """The port's stdout, FATAL ERROR line and rc equal the JAX CLI's."""
    got = _port(capsys, *args)
    assert got == _jax(capsys, *args), args
    return got


def _fasta(tmp_path, name, q, t, comment=None):
    path = tmp_path / name
    head = f" {comment}" if comment is not None else ""
    path.write_text(f">q\n{q}\n>t{head}\n{t}\n")
    return str(path)


FIXTURE_ARGS = [
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


@pytest.mark.parametrize("args", FIXTURE_ARGS, ids=" ".join)
def test_fixture_matches_jax_cli(capsys, args):
    args = [*args[:-1], os.path.join(TEST, args[-1])]
    out, fatal, rc = _same(capsys, *args)
    assert rc == 0 and out and not fatal
    if "-s" in args:
        assert out.splitlines()[0] == "100|340|580"  # the junction echo


MICRO = [
    ("global", "ACGT", "ACGT", ()),
    ("global", "ACGT", "AGT", ()),
    ("local", "GATTACA", "GCATGCU", ()),
    ("overlap", "ACGT", "AGT", ()),  # the empty-alignment j_max = 0 case
    ("edit", "GATTACA", "GCATGCU", ("-u", "1")),
]


@pytest.mark.parametrize("mode,q,t,opts", MICRO)
def test_micro_matches_jax_cli(capsys, tmp_path, mode, q, t, opts):
    out, _, rc = _same(capsys, mode, *opts, _fasta(tmp_path, "m.fa", q, t))
    assert rc == 0
    if mode == "edit":
        assert out == "edit_distance=4\n"


def _random_pairs(alphabet, seed, k=3):
    """Seeded pairs with m <= n (fit's requirement) and three junction
    sites in [0, n) a target."""
    rng = np.random.default_rng(seed)
    alpha = np.frombuffer(ALPHABETS[alphabet], dtype=np.uint8)
    out = []
    for _ in range(k):
        m = int(rng.integers(1, 90))
        n = int(rng.integers(m, 200))
        q, t = (alpha[rng.integers(0, len(alpha), x)].tobytes()
                for x in (m, n))
        out.append((q, t, sorted(int(x) for x in rng.integers(0, n, 3))))
    return out


@pytest.mark.parametrize("alphabet", sorted(ALPHABETS))
@pytest.mark.parametrize("mode", MODES)
def test_random_pairs_match_jax_cli(capsys, tmp_path, mode, alphabet):
    seed = MODES.index(mode) * 2 + (alphabet == "binary")
    for k, (q, t, sites) in enumerate(_random_pairs(alphabet, seed)):
        path = _fasta(tmp_path, f"r{k}.fa", q.decode(), t.decode(),
                      "|".join(map(str, sites)))
        opts = [["-m", "2", "-u", "-3", "-o", "-4"], [], ["-e", "-2"]][k]
        if mode == "fit" and k != 1:
            opts.append("-s")
        out, fatal, rc = _same(capsys, mode, *opts, path)
        assert rc == 0 and not fatal


def _one_record(tmp_path):
    path = tmp_path / "one.fa"
    path.write_text(">q\nACGT\n")
    return str(path)


def _three_records(tmp_path):
    path = tmp_path / "three.fa"
    path.write_text(">a\nACGT\n>b\nACG\n>c\nAC\n")
    return str(path)


ERRORS = {
    "missing file": (lambda p: ["global", str(p / "absent.fa")], 255),
    "one record": (lambda p: ["local", _one_record(p)], 255),
    "three records": (lambda p: ["global", _three_records(p)], 255),
    "-s without a comment": (
        lambda p: ["fit", "-s", _fasta(p, "nc.fa", "ACG", "ACGT")], 255),
    "fit with m > n": (
        lambda p: ["fit", _fasta(p, "mn.fa", "ACGTA", "ACG")], 255),
    "bad flag": (lambda p: ["global", "-z", os.path.join(TEST,
                                                         "test_global.fa")],
                 1),
    "-s outside fit": (lambda p: ["local", "-s", os.path.join(
        TEST, "test_local.fa")], 1),
    "mode without a file": (lambda p: ["edit"], 1),
    "no arguments": (lambda p: [], 1),
    "unknown command": (lambda p: ["bogus", "x.fa"], 1),
}


@pytest.mark.parametrize("case", sorted(ERRORS))
def test_error_surfaces_match_jax_cli(capsys, tmp_path, case):
    make, want_rc = ERRORS[case]
    args = make(tmp_path)
    rc_port = main(list(args))
    port = capsys.readouterr()
    rc_jax = jax_main(["aligntools", *args])
    jax = capsys.readouterr()
    assert rc_port == rc_jax == want_rc
    assert port.out == jax.out == ""
    assert _fatal(port.err) == _fatal(jax.err)
    assert bool(_fatal(port.err)) == (want_rc == 255)
    if case == "unknown command":
        assert port.err == jax.err == "[main] unrecognized command 'bogus'\n"


EMPTY_SIDES = [(mode, q, t) for mode in MODES
               for q, t in (("", "ACGT"), ("ACGT", ""), ("", ""))]
# where the JAX CLI's spec route departs from its device route: what the
# JAX CLI gives, and what the port (= scan_align) prints
EMPTY_DEPARTURES = {
    ("local", "ACGT", ""): ("FATAL ERROR: zero-size array",
                            "score=-inf\n\n\n"),
    ("overlap", "ACGT", ""): (IndexError, "-inf\n\n\n"),
    ("overlap", "", ""): (IndexError, "-inf\n\n\n"),
    ("fit", "", "ACGT"): ("FATAL ERROR: fit: empty query",
                          "score=0.000000\n\n\n"),
    ("fit", "", ""): ("FATAL ERROR: fit: empty query",
                      "FATAL ERROR: fit: no finite traceback start"),
}


def _result(fn):
    try:
        r = fn()
    except (ValueError, RuntimeError) as err:
        return type(err).__name__, str(err)
    return r if isinstance(r, int) else (r.score, r.row1, r.row2)


@pytest.mark.parametrize("mode,q,t", EMPTY_SIDES)
def test_empty_sides(capsys, tmp_path, mode, q, t):
    """api: equal to scan_align on all 15; CLI: equal to the JAX CLI on
    the ten where its spec route agrees with scan_align, and to the JAX
    device route (the table) on the other five."""
    want = _result(lambda: scan_align(mode, q.encode(), t.encode(),
                                      JaxParams(), None))
    got = _result(lambda: api.align_pair(mode, q.encode(), t.encode(),
                                         device="cpu"))
    assert got == want
    path = _fasta(tmp_path, "e.fa", q, t)
    if (mode, q, t) not in EMPTY_DEPARTURES:
        _same(capsys, mode, path)
        return
    jax_says, port_says = EMPTY_DEPARTURES[(mode, q, t)]
    out, fatal, rc = _port(capsys, mode, path)
    if port_says.startswith("FATAL ERROR"):
        assert (out, rc) == ("", 255) and fatal[0].startswith(port_says)
    else:
        assert (out, fatal, rc) == (port_says, [], 0)
    if jax_says is IndexError:
        with pytest.raises(IndexError):
            jax_main(["aligntools", mode, path])
    else:
        out, fatal, rc = _jax(capsys, mode, path)
        assert (out, rc) == ("", 255) and fatal[0].startswith(jax_says)


# odd params near 2^20 (-o past 2^21): every fixture pair passes float32's
# exact integers (max|param| * (m+n+1) >= 2^24)
BIG_OPTS = ("-m", "1048573", "-u", "-1048571", "-o", "-3145739", "-e",
            "-1048577")


@pytest.mark.parametrize("mode", MODES)
def test_f32_range_is_refused(capsys, mode):
    """A pair past float32's exact integers: the per-mode command's stdout,
    FATAL ERROR line and exit code equal the JAX CLI's (its spec engine,
    in double; the port's double instances), and align_pair gives the
    spec engine's result; only the batch path refuses such a pair (FATAL
    ERROR, 255), as ``aligntools batch`` does."""
    fixture = {"fit": "test_fit.fa", "overlap": "test_overlap.fa"}.get(
        mode, f"test_{mode}.fa")
    path = os.path.join(TEST, fixture)
    out, fatal, rc = _same(capsys, mode, *BIG_OPTS, path)
    assert rc == 0 and out and not fatal
    out, fatal, rc = _port(capsys, "batch", mode, path, *BIG_OPTS,
                           "--device", "cpu")
    assert (out, rc) == ("", 255) and "exact-integer range" in fatal[0]
    kw = dict(match=1 << 20, mismatch=-(1 << 20) + 1, gap_open=-(1 << 21),
              gap_extend=-(1 << 20) - 1)
    q, t = b"ACGTTGCA" * 4, b"ACGATGCAT" * 4
    got = api.align_pair(mode, q, t, AlignParams(**kw), device="cpu")
    want = jax_align_pair(mode, q, t, JaxParams(**kw), engine="spec")
    if mode == "edit":
        assert type(got) is int and got == want
    else:
        assert (got.score, got.row1, got.row2) == (want.score, want.row1,
                                                   want.row2)


def test_api_guards():
    with pytest.raises(ValueError, match="unknown mode"):
        api.align_pair("semiglobal", b"A", b"A", device="cpu")
    with pytest.raises(ValueError, match="only meaningful in fit"):
        api.align_pair("local", b"A", b"A", sites=[0], device="cpu")


def _scan_cases():
    """Seeded pairs whose lengths fall in two 128-column pads a side (each
    scan_align call compiles one program per mode and padded shape), and
    the fixtures."""
    rng = np.random.default_rng(11)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    cases = []
    for k in range(4):
        m = int(rng.integers(1, 120)) if k % 2 else int(rng.integers(129, 200))
        n = int(rng.integers(max(m, 129), 250))
        cases.append((alpha[rng.integers(0, 4, m)].tobytes(),
                      alpha[rng.integers(0, 4, n)].tobytes()))
    return cases


@pytest.mark.parametrize("mode", MODES)
def test_align_pair_matches_scan_align(mode):
    fixture = {"fit": "test_fit.fa", "overlap": "test_overlap.fa"}.get(
        mode, f"test_{mode}.fa")
    pair = read_pair(os.path.join(TEST, fixture))
    jp = JaxParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-2,
                   jump=-6)
    tp = AlignParams(match=2, mismatch=-3, gap_open=-4, gap_extend=-2,
                     jump=-6)
    for q, t in [(pair.seq1, pair.seq2), *_scan_cases()]:
        for jparams, tparams in ((JaxParams(), AlignParams()), (jp, tp)):
            want = scan_align(mode, q, t, jparams, None)
            got = api.align_pair(mode, q, t, tparams, device="cpu")
            if mode == "edit":
                assert type(got) is int and got == want
            else:
                assert (got.score, got.row1, got.row2) == (
                    want.score, want.row1, want.row2), (mode, len(q), len(t))


def test_align_pair_sites_match_scan_align():
    """Sites turn the jump state on even when the list is empty; sites
    that are negative, past n or repeated are ignored or count once, as
    in scan_align."""
    pair_sites = read_pair(os.path.join(TEST, "test_fit.fa"), want_sites=True)
    q, t = pair_sites.seq1, pair_sites.seq2
    n = len(t)
    for sites in ([], pair_sites.sites, [-5, -1, 0, 100, 100, n - 1, n,
                                          n + 1, n + 500],
                  [340, 340, 340, -340]):
        want = scan_align("fit", q, t, JaxParams(), sites)
        got = api.align_pair("fit", q, t, AlignParams(), sites, device="cpu")
        assert (got.score, got.row1, got.row2) == (
            want.score, want.row1, want.row2), sites
    no_jump = api.align_pair("fit", q, t, device="cpu")
    assert no_jump.score == scan_align("fit", q, t, JaxParams(), None).score


def test_align_file_returns_the_pair():
    path = os.path.join(TEST, "test_fit.fa")
    result, pair = api.align_file("fit", path, use_sites=True, device="cpu")
    assert pair.sites == [100, 340, 580] and pair.comment2 == b"100|340|580"
    assert result == api.align_pair("fit", pair.seq1, pair.seq2,
                                    sites=pair.sites, device="cpu")


def test_unported_commands_are_refused(capsys, monkeypatch):
    """``batch --sharded``, once refused, is ported: it prints the scores
    (a one-rank group here), as ``aligntools batch --sharded`` does;
    ``calibrate`` is ported and measures the card, so without one it ends
    in FATAL ERROR, 255, and writes no table."""
    path = os.path.join(TEST, "test_global.fa")
    assert main(["batch", "global", path, "--device", "cpu",
                 "--sharded"]) == 0
    out = capsys.readouterr().out
    assert main(["batch", "global", path, "--device", "cpu",
                 "--scores-only"]) == 0
    assert out == capsys.readouterr().out and out.count("\n") == 1
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert main(["calibrate", "--force"]) == 255
    cap = capsys.readouterr()
    assert cap.out == "" and _fatal(cap.err)
    assert "torch.cuda.is_available() is false" in cap.err


def test_device_unset_without_cuda_is_fatal():
    """ALIGNTOOLS_DEVICE unset on a host without a usable card: the
    per-mode command and serve end in FATAL ERROR, exit 255, and name the
    switch to the CPU; nothing runs quietly on the CPU."""
    env = {k: v for k, v in os.environ.items() if k != "ALIGNTOOLS_DEVICE"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    code = ("import sys\nfrom aligntools_tpu_torch.cli import main\n"
            "sys.exit(main(sys.argv[1:]))\n")
    for args in (["global", "test/test_global.fa"], ["serve"]):
        r = subprocess.run([sys.executable, "-c", code, *args], cwd=REPO,
                           env=env, capture_output=True, text=True,
                           timeout=120, input="")
        assert r.returncode == 255 and r.stdout == "", args
        assert "FATAL ERROR" in r.stderr
        assert "ALIGNTOOLS_DEVICE=cpu" in r.stderr


def test_fresh_process_never_imports_jax(capsys):
    """``python3 -m aligntools_tpu_torch global FILE`` in a fresh
    interpreter prints the JAX CLI's bytes and loads no module of jax, the
    JAX package or ``tools``."""
    env = dict(os.environ, ALIGNTOOLS_DEVICE="cpu")
    code = (
        "import runpy, sys\n"
        "sys.argv = ['aligntools_tpu_torch', 'global',\n"
        "            'test/test_global.fa']\n"
        "try:\n"
        "    runpy.run_module('aligntools_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [k for k in sys.modules\n"
        "       if k.split('.')[0] in ('jax', 'jaxlib', 'aligntools_tpu',\n"
        "                              'tools')]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    out, _, rc = _jax(capsys, "global", os.path.join(TEST, "test_global.fa"))
    assert rc == 0 and r.stdout == out

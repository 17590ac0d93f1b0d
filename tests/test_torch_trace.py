"""``aligntools-torch batch ... --trace DIR`` on the CPU: a torch.profiler
Chrome trace of the run's loop, with the TSV byte-equal to the untraced
run's; without the flag no trace and no profiler."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import json
import os

import numpy as np
import pytest
import torch

from aligntools_tpu_torch.cli import main
from aligntools_tpu_torch.utils import profiling

OUTPUTS = {"rows": [], "scores-only": ["--scores-only"], "cigar": ["--cigar"],
           "band": ["--band", "16"]}


def _fasta(tmp_path, n_pairs=12, seed=3):
    """Pairs of close lengths (inside a band of 16), two length groups."""
    rng = np.random.default_rng(seed)
    lines = []
    for k in range(n_pairs):
        m = int(rng.integers(20, 40 if k % 2 else 90))
        n = m + int(rng.integers(0, 8))
        q = bytes(rng.choice(list(b"ACGT"), m).tolist()).decode()
        t = bytes(rng.choice(list(b"ACGT"), n).tolist()).decode()
        lines += [f">q{k}", q, f">t{k}", t]
    path = tmp_path / "pairs.fa"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


def _batch(capsys, *args):
    rc = main(["batch", *args])
    out = capsys.readouterr().out
    assert rc == 0
    return out


@pytest.mark.parametrize("output", list(OUTPUTS))
def test_trace_writes_a_chrome_trace_and_the_same_tsv(tmp_path, capsys,
                                                      output):
    fa = _fasta(tmp_path)
    d = tmp_path / "trace"
    args = ["global", fa, "--device", "cpu", *OUTPUTS[output]]
    traced = _batch(capsys, *args, "--trace", str(d))
    assert traced == _batch(capsys, *args)
    assert os.listdir(d) == ["trace.json"]
    with open(d / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    # the fills run on the pipeline's prefetch thread: its ops are traced
    ops = [ev for ev in events if ev.get("cat") == "cpu_op"]
    assert ops and {ev["tid"] for ev in ops} - {os.getpid()}
    assert len(traced.splitlines()) == 12


def test_no_trace_without_the_flag(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)
    fa = _fasta(tmp_path)
    _batch(capsys, "local", fa, "--device", "cpu", "--out",
           str(tmp_path / "out.tsv"))
    assert sorted(os.listdir(tmp_path)) == ["out.tsv", "pairs.fa"]


def test_device_trace_without_a_directory_touches_no_profiler(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("the profiler was started")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    for d in (None, ""):
        with profiling.device_trace(d, "cpu"):
            x = torch.ones(3) + 1
        assert x.sum() == 6


def test_trace_file_names_the_rank(tmp_path):
    assert profiling.trace_file(str(tmp_path)) == str(tmp_path /
                                                      "trace.json")
    assert profiling.trace_file(str(tmp_path), 3) == str(
        tmp_path / "trace.rank3.json")

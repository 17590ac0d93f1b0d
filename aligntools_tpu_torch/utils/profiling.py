"""Run counters and stage timers (copied from
``aligntools_tpu/utils/profiling.py``), and ``device_trace``, the
counterpart of its jax.profiler hook on torch.profiler."""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import sys
import time


@dataclasses.dataclass
class Counters:
    """Cumulative throughput counters for a pipeline run."""

    pairs: int = 0
    cells: int = 0  # sum of m*n over aligned pairs (true lengths, not pads)
    padded_cells: int = 0  # sum over bucket shapes actually executed
    seconds: float = 0.0
    io_seconds: float = 0.0
    traceback_seconds: float = 0.0
    # stage decomposition (may SUM past ``seconds`` when the pipeline
    # overlaps host formatting with the next chunk's device work)
    encode_seconds: float = 0.0  # bucketize + int32 encode + pad
    fill_seconds: float = 0.0  # device fills incl. dispatch + sync
    walk_seconds: float = 0.0  # traceback walks + row assembly
    format_seconds: float = 0.0  # TSV formatting + write

    @property
    def gcups(self) -> float:
        return self.cells / self.seconds / 1e9 if self.seconds else 0.0

    @property
    def pairs_per_sec(self) -> float:
        return self.pairs / self.seconds if self.seconds else 0.0

    @property
    def pad_efficiency(self) -> float:
        """Fraction of executed cells that were true cells (bucketing waste)."""
        return self.cells / self.padded_cells if self.padded_cells else 0.0

    def report(self, stream=None) -> None:
        stream = stream if stream is not None else sys.stderr
        extras = [f"{self.pairs_per_sec:.1f} pairs/s",
                  f"io {self.io_seconds:.3f}s"]
        if self.padded_cells:
            extras.append(f"pad-efficiency {self.pad_efficiency:.1%}")
        if self.traceback_seconds:
            extras.append(f"traceback {self.traceback_seconds:.3f}s")
        for name, val in (("encode", self.encode_seconds),
                          ("fill", self.fill_seconds),
                          ("walk", self.walk_seconds),
                          ("format", self.format_seconds)):
            if val:
                extras.append(f"{name} {val:.3f}s")
        stream.write(
            f"[aligntools] {self.pairs} pairs, {self.cells / 1e9:.3f} Gcells "
            f"in {self.seconds:.3f}s = {self.gcups:.2f} GCUPS "
            f"({', '.join(extras)})\n"
        )


@contextlib.contextmanager
def stopwatch(counters: Counters, field: str = "seconds"):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        setattr(
            counters, field, getattr(counters, field) + time.perf_counter() - t0
        )


# the Chrome trace's categories of work on the card
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def trace_file(trace_dir: str, rank: int | None = None) -> str:
    """The Chrome trace ``device_trace`` writes into ``trace_dir``: one a
    rank where several ranks run."""
    name = "trace.json" if rank is None else f"trace.rank{rank}.json"
    return os.path.join(trace_dir, name)


@contextlib.contextmanager
def device_trace(trace_dir: str | None, device, rank: int | None = None):
    """torch.profiler over the region when a directory is given (CPU
    activity, and CUDA activity on a CUDA device), written as a Chrome
    trace (``trace_file``); without one it does nothing. On a CUDA device
    a trace that holds no device event raises RuntimeError rather than
    pass for a CPU-only trace."""
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    # the pipeline's fills run on its prefetch thread: trace every thread
    from torch._C._profiler import _ExperimentalConfig

    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        yield
        if on_card:
            torch.cuda.synchronize(device)
    os.makedirs(trace_dir, exist_ok=True)
    path = trace_file(trace_dir, rank)
    prof.export_chrome_trace(path)
    if on_card:
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
        if not any(ev.get("cat") in DEVICE_CATS for ev in events):
            raise RuntimeError(f"--trace: {path} holds no CUDA event (the "
                               f"profiler did not trace the card)")

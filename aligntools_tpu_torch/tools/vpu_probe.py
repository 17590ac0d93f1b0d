"""The card's chained max+add ceiling: the H100 counterpart of
``tools/vpu_probe.py``.

    python3 -m aligntools_tpu_torch.tools.vpu_probe [--quick]

Every probe runs the JAX module's body, per element
``y = max(y + a, b) - a`` (3 ops a link), through the hand-written kernel
of ``csrc/vpu_probe.cu``:

  vmem_ceiling          ONE dependent chain an element, (32, 1024), chain
                        2,048, float32 / int32 / int16: the latency of a
                        link at ~8 warps an SM, not the issue rate;
  roofline_ops_per_sec  8 independent chains an element, (64, 2048), chain
                        4,096: the saturated issue rate of one dtype, in
                        op/s, for a caller that divides a same-run rate by
                        it (``bench.py`` does so on the TPU);
  vpu_roofline          the same at chain 256 for every form of float32,
                        int32, bfloat16 and int16;
  elementwise_ceiling   the same link as eager torch ops, one launch an op:
                        the rate of eager elementwise launches, not of the
                        ALU (the JAX version is an XLA loop through HBM);
  fill_scaling          the port's local score fill (``ops.scan.scores``)
                        at the JAX module's three tile-sweep cases, GCUPS
                        and whether repeat runs are bit-equal. The port
                        runs one CTA a pair and has no ``tile_b`` to sweep.

Forms (``FORMS``): how Hopper runs the same per-element function in a
dtype, ``plain`` (f32 FADD/FMNMX, i32 IADD3/IMNMX, i16 scalar short),
``dpx`` (the fused add-max ``__viaddmax_s32``, or ``__viaddmax_s16x2`` on
packed int16 pairs) and ``x2`` (packed ``__nv_bfloat162``). The measuring
functions raise on a device other than CUDA: no CPU time is ever reported
as the card's. ``chain`` on a CPU tensor runs ``chain_plain``.
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

# dtype name -> (torch dtype, the kernel's dtype code)
DTYPES = {"float32": (torch.float32, 0), "int32": (torch.int32, 1),
          "int16": (torch.int16, 2), "bfloat16": (torch.bfloat16, 3)}
# the forms of each dtype, the first its default
FORMS = {"float32": ("plain",), "int32": ("plain", "dpx"),
         "int16": ("plain", "dpx"), "bfloat16": ("x2",)}
_FORM_CODE = {"plain": 0, "dpx": 1, "x2": 2}
# (dtype, form, width): the kernel's nine instantiations
VARIANTS = (
    ("float32", "plain", 1), ("float32", "plain", 8),
    ("int32", "plain", 1), ("int32", "plain", 8), ("int32", "dpx", 8),
    ("int16", "plain", 1), ("int16", "plain", 8), ("int16", "dpx", 8),
    ("bfloat16", "x2", 8),
)
OPS_PER_LINK = 3

# launches of the kernel through ``chain`` (one chain: vmem_ceiling's;
# several: the ILP probes'), and calls of the plain version
launches = {"probe_chain": 0, "probe_ilp": 0}
plain_calls = 0


def reset_counts() -> None:
    global plain_calls
    for k in launches:
        launches[k] = 0
    plain_calls = 0


def _packed(dtype: str, form: str) -> bool:
    """Whether ``form`` holds two elements a 32-bit register."""
    return form == "x2" or (form == "dpx" and dtype == "int16")


def ops_per_instruction(dtype: str, form: str) -> float:
    """Ops an instruction does where a link takes the fewest instructions
    it can: 3 for float32 and bfloat16 (no instruction adds three floats,
    or adds and maxes them), 2 for the integer forms (IADD3 adds three,
    VIADDMNMX adds and maxes), on two elements for a packed form."""
    fewest = 3 if dtype in ("float32", "bfloat16") else 2
    return OPS_PER_LINK * (2 if _packed(dtype, form) else 1) / fewest


def _form(dtype, form):
    if dtype not in DTYPES:
        raise ValueError(f"unsupported dtype {dtype!r}: one of {list(DTYPES)}")
    return FORMS[dtype][0] if form is None else form


def _dtype_name(x: torch.Tensor) -> str:
    for name, (dt, _) in DTYPES.items():
        if x.dtype == dt:
            return name
    raise ValueError(f"unsupported dtype {x.dtype}: one of {list(DTYPES)}")


# ---------------------------------------------------------------------------
# The kernel and its plain version
# ---------------------------------------------------------------------------


def chain_plain(a, b, chain, width):
    """Plain version of ``chain`` (any device): the JAX body written out.
    One chain starts from b; several from b + w, summed in order."""
    global plain_calls
    plain_calls += 1
    ys = [b] if width == 1 else [b + w for w in range(width)]
    for _ in range(chain):
        ys = [torch.maximum(y + a, b) - a for y in ys]
    acc = ys[0]
    for y in ys[1:]:
        acc = acc + y
    return acc


_lib = None


def _kernel():
    global _lib
    if _lib is None:
        from aligntools_tpu_torch.ops import _build

        lib = _build.load()
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.at_vpu_chain.argtypes = [I, I, I, P, P, P, ctypes.c_longlong, I,
                                     P]
        lib.at_vpu_chain.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(a, b, chain, width, form):
    """(dtype, form) of a valid call; raises on anything the kernel does
    not take."""
    dtype = _dtype_name(a)
    form = _form(dtype, form)
    if (dtype, form, width) not in VARIANTS:
        raise ValueError(f"no kernel variant {dtype}/{form}/width {width}: "
                         f"one of {VARIANTS}")
    if b.dtype != a.dtype or b.shape != a.shape or b.device != a.device:
        raise ValueError(f"b ({b.dtype} {tuple(b.shape)} on {b.device}) "
                         f"must match a ({a.dtype} {tuple(a.shape)} on "
                         f"{a.device})")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if not isinstance(chain, int) or chain < 0:
        raise ValueError(f"chain must be a non-negative int, got {chain!r}")
    return dtype, form


def launcher(a, b, chain, width, form=None):
    """A function of no arguments that launches the kernel of
    ``csrc/vpu_probe.cu`` on CUDA tensors ``a`` and ``b`` into a new tensor
    and returns it. The checks run once, here, so a timing loop pays only
    the launch; each call is counted."""
    dtype, form = _check(a, b, chain, width, form)
    if a.device.type != "cuda":
        raise ValueError(f"the kernel takes CUDA tensors, not {a.device}")
    out = torch.empty_like(a)
    if _packed(dtype, form) and any(x.data_ptr() % 4 for x in (a, b)):
        raise ValueError("the packed forms need 4-byte aligned tensors")
    fn = _kernel().at_vpu_chain
    stream = torch.cuda.current_stream(a.device).cuda_stream
    args = (DTYPES[dtype][1], _FORM_CODE[form], width, a.data_ptr(),
            b.data_ptr(), out.data_ptr(), a.numel(), chain, stream)
    key = "probe_chain" if width == 1 else "probe_ilp"

    def launch():
        if a.numel():
            err = fn(*args)
            if err != 0:
                raise RuntimeError(f"vpu_probe kernel launch failed: CUDA "
                                   f"error {err}")
            launches[key] += 1
        return out

    return launch


def chain(a, b, chain, width, form=None):
    """``chain`` links of y = max(y + a, b) - a on ``width`` chains an
    element, summed (see the module docstring); ``form`` defaults to the
    dtype's first. On a CUDA tensor it launches the kernel of
    ``csrc/vpu_probe.cu`` or raises; on a CPU tensor it runs
    ``chain_plain``."""
    if a.device.type == "cpu":
        _check(a, b, chain, width, form)
        return chain_plain(a, b, chain, width)
    launch = launcher(a, b, chain, width, form)
    with torch.cuda.device(a.device):
        return launch()


# ---------------------------------------------------------------------------
# Timing on the card
# ---------------------------------------------------------------------------


def _card(device) -> torch.device:
    """The CUDA device to measure on; raises on any other."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise RuntimeError(f"the probe measures the card; {device!r} is not "
                           f"a CUDA device")
    if not torch.cuda.is_available():
        raise RuntimeError("the probe measures the card, and "
                           "torch.cuda.is_available() is false")
    return dev


def _event_seconds(fn) -> float:
    """Device seconds of ``fn``'s work on the current stream (CUDA
    events)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _amortized(run_k, reps=2, k1=1, k2=5, timer=_event_seconds):
    """Seconds a unit of ``run_k``: the best of ``reps`` timings of
    run_k(K2) less that of run_k(K1), over K2 - K1, each warmed once. A
    non-positive difference widens K2 fourfold once, then raises."""
    def timed(K):
        run_k(K)
        return min(timer(lambda: run_k(K)) for _ in range(reps))

    per = (timed(k2) - timed(k1)) / (k2 - k1)
    if per <= 0:
        per = (timed(4 * k2) - timed(k1)) / (4 * k2 - k1)
    if per <= 0:
        raise RuntimeError("amortized timing non-positive twice: the "
                           "difference is below the timer's noise")
    return per


def _ones_zeros(dtype, shape, dev):
    dt = DTYPES[dtype][0]
    return (torch.ones(shape, dtype=dt, device=dev),
            torch.zeros(shape, dtype=dt, device=dev))


def _result(probe, dtype, form, width, shape, chain, seconds, measures):
    ops = OPS_PER_LINK * width * float(np.prod(shape)) * chain
    return {"probe": probe, "dtype": dtype, "form": form, "width": width,
            "shape": tuple(shape), "chain": chain, "seconds": seconds,
            "ops_per_s": ops / seconds, "measures": measures}


def _print(r):
    name = r["dtype"] + ("" if r["form"] == "plain" else f"/{r['form']}")
    print(f"  {name:12s}: {r['ops_per_s'] / 1e12:7.3f} Tops/s "
          f"({r['seconds'] * 1e3:8.4f} ms a launch)", flush=True)


def vmem_ceiling(shape=(32, 1024), chain=2048, device="cuda"):
    """One dependent chain an element, y = max(y + a, b) - a from y = b,
    for float32, int32 and int16: the mean of 20 launches after a warm-up.
    At the default shape (~8 warps an SM) it measures a link's latency."""
    dev = _card(device)
    print(f"# one-chain ceiling, shape {shape}, chain {chain}")
    out = []
    with torch.cuda.device(dev):
        for dtype in ("float32", "int32", "int16"):
            a, b = _ones_zeros(dtype, shape, dev)
            launch, reps = launcher(a, b, chain, 1), 20
            launch()

            def run():
                for _ in range(reps):
                    launch()

            per = _event_seconds(run) / reps
            out.append(_result("vmem_ceiling", dtype, "plain", 1, shape,
                               chain, per, "latency of one dependent chain"))
            _print(out[-1])
    return out


def _ilp_rate(dtype="float32", shape=(64, 2048), chain=4096, width=8,
             form=None, reps=3, k1=2, k2=12, device="cuda"):
    """One form's saturated rate (a result dict): ``width`` independent
    chains an element; between launches ``a = max(a, r)``, as the JAX
    outer loop feeds each result back."""
    dev = _card(device)
    form = _form(dtype, form)
    with torch.cuda.device(dev):
        a, b = _ones_zeros(dtype, shape, dev)
        carry = torch.empty_like(a)
        launch = launcher(carry, b, chain, width, form)

        def run_k(K):
            carry.copy_(a)
            for _ in range(K):
                torch.maximum(carry, launch(), out=carry)

        per = _amortized(run_k, reps=reps, k1=k1, k2=k2)
    return _result("roofline", dtype, form, width, shape, chain, per,
                   f"issue rate, {width} independent chains a thread")


def roofline_ops_per_sec(dtype="float32", shape=(64, 2048), chain=4096,
                         width=8, device="cuda"):
    """One dtype's saturated chained max+add rate in op/s (its default
    form), for a caller that reports a same-run rate against it. One launch
    at the defaults is ~12.9 G ops; timed over launches 2 and 12."""
    return _ilp_rate(dtype, shape, chain, width, reps=3, k1=2, k2=12,
                     device=device)["ops_per_s"]


def vpu_roofline(shape=(64, 2048), chain=256, width=8, device="cuda"):
    """The saturated rate of every form of float32, int32, bfloat16 and
    int16 (a list of result dicts)."""
    _card(device)
    print(f"# chained max+add roofline, shape {shape}, chain {chain}, "
          f"width {width}")
    out = []
    for dtype in ("float32", "int32", "bfloat16", "int16"):
        for form in FORMS[dtype]:
            out.append(_ilp_rate(dtype, shape, chain, width, form, reps=2,
                                 k1=1, k2=5, device=device))
            _print(out[-1])
    return out


def elementwise_ceiling(shape=(256, 2048), chain=512, device="cuda"):
    """The link as eager torch ops, three launches a link: the rate of
    eager elementwise launches through device memory, not of the ALU."""
    dev = _card(device)
    print(f"# eager elementwise ceiling (launch-bound, not the ALU), shape "
          f"{shape}, chain {chain}")
    out = []
    for dtype in ("float32", "int32", "int16", "bfloat16"):
        dt = DTYPES[dtype][0]
        a = torch.ones(shape, dtype=dt, device=dev)
        b = torch.zeros(shape, dtype=dt, device=dev)

        def run_k(K):
            y = b
            for _ in range(K * chain):
                y = torch.maximum(y + a, b) - a
            return y

        per = _amortized(run_k)
        r = _result("elementwise", dtype, "eager", 1, shape, chain, per,
                    "eager elementwise launches")
        out.append(r)
        print(f"  {dtype:12s}: {r['ops_per_s'] / 1e12:7.3f} Tops/s "
              f"({per * 1e6 / chain:7.3f} us per 3-op link)", flush=True)
    return out


def fill_scaling(quick=False, device="cuda"):
    """The port's local score fill at the JAX module's tile-sweep cases:
    GCUPS, and whether every repeat run equals the first bit for bit."""
    from aligntools_tpu_torch.ops import scan

    dev = _card(device)
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGT", dtype=np.uint8)
    cases = [(256, 2048), (64, 2048), (32, 8192)]
    out = []
    for B, L in cases[:1] if quick else cases:
        def put(x, dt=torch.int32):
            return torch.from_numpy(np.ascontiguousarray(x)).to(dev, dt)

        qs = put(rng.choice(alpha, (B, L)).astype(np.int32))
        ts = put(rng.choice(alpha, (B, L)).astype(np.int32))
        ns = ms = put(np.full((B, 1), L, np.int32))
        pm = np.zeros((1, 8), np.float32)
        pm[0, :5] = [1, -2, -5, -1, -10]
        pm = put(pm, torch.float32)
        print(f"# local fill {B}x{L}^2 (one CTA a pair; no tile_b to sweep)")
        seen = []

        def run_k(K):
            for _ in range(K):
                seen.append(scan.scores("local", L, L, qs, ts, ns, ms, pm))

        per = _amortized(run_k)
        exact = all(torch.equal(s, seen[0]) for s in seen)
        r = {"probe": "fill_scaling", "mode": "local", "B": B, "L": L,
             "seconds": per, "gcups": B * L * L / per / 1e9, "exact": exact,
             "runs": len(seen)}
        out.append(r)
        print(f"  {r['gcups']:6.1f} GCUPS ({per * 1e3:7.2f} ms) "
              f"exact={exact}", flush=True)
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    quick = "--quick" in argv
    dev = _card("cuda")
    print(f"backend: cuda {torch.cuda.get_device_name(dev)}")
    elementwise_ceiling(chain=128 if quick else 512)
    vpu_roofline(chain=64 if quick else 256)
    fill_scaling(quick)
    return 0


if __name__ == "__main__":
    sys.exit(main())

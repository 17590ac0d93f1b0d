"""The port's ceiling probe (``aligntools_tpu_torch.tools.vpu_probe``)
against the JAX module ``tools/vpu_probe.py``, on the CPU.

The JAX module builds its Pallas kernels inside its measuring functions.
The test captures each kernel body by standing a fake in for
``pallas_call`` (the module itself is not edited), runs the body in
interpret mode, and holds ``chain_plain`` bit-equal to it. The measuring
functions of the port raise here: they measure the card only."""

import torch_cpu  # noqa: F401  (first: one torch thread a worker)

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from aligntools_tpu_torch.tools import vpu_probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPE = (8, 128)
CHAIN = 5
# (case id, the JAX function that builds it, dtype, chains an element), in
# the order the JAX functions reach pallas_call
CASES = [
    ("9a-float32", "vmem_ceiling", "float32", 1),
    ("9a-int32", "vmem_ceiling", "int32", 1),
    ("9a-int16", "vmem_ceiling", "int16", 1),
    ("9c-float32", "vpu_roofline", "float32", 8),
    ("9c-int32", "vpu_roofline", "int32", 8),
    ("9c-bfloat16", "vpu_roofline", "bfloat16", 8),
    ("9c-int16", "vpu_roofline", "int16", 8),
    ("9b-float32", "roofline_ops_per_sec", "float32", 8),
]


class _Captured(Exception):
    pass


@pytest.fixture(scope="module")
def jax_kernels():
    """{case id: (kernel body, out_shape)} from the JAX module's three
    functions at SHAPE and CHAIN."""
    spec = importlib.util.spec_from_file_location(
        "jax_vpu_probe", os.path.join(REPO, "tools", "vpu_probe.py"))
    jvp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jvp)
    seen = []

    def fake(kern, out_shape=None, **_):
        seen.append((kern, out_shape))
        raise _Captured

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental.pallas, "pallas_call", fake)
        jvp.vmem_ceiling(shape=SHAPE, chain=CHAIN)  # catches per dtype
        jvp.vpu_roofline(shape=SHAPE, chain=CHAIN)
        with pytest.raises(_Captured):
            jvp.roofline_ops_per_sec("float32", shape=SHAPE, chain=CHAIN)
    assert len(seen) == len(CASES)
    return {case[0]: got for case, got in zip(CASES, seen)}


def _bits(x):
    """The raw bits of a numpy or torch array, as unsigned integers."""
    if isinstance(x, torch.Tensor):
        x = x.view({2: torch.int16, 4: torch.int32}[x.element_size()]).numpy()
    x = np.asarray(x)
    return x.view({2: np.uint16, 4: np.uint32}[x.dtype.itemsize])


@pytest.mark.parametrize("case,fn,dtype,width", CASES,
                         ids=[c[0] for c in CASES])
def test_chain_plain_equals_jax_kernel(jax_kernels, case, fn, dtype, width):
    kern, out_shape = jax_kernels[case]
    assert out_shape.shape == SHAPE and out_shape.dtype == jnp.dtype(dtype)
    rng = np.random.default_rng(len(case) * 31 + width)
    a = rng.integers(-8, 9, SHAPE)
    b = rng.integers(-8, 9, SHAPE)
    want = pl.pallas_call(kern, out_shape=out_shape, interpret=True)(
        jnp.asarray(a, dtype), jnp.asarray(b, dtype))
    tdt = vpu_probe.DTYPES[dtype][0]
    got = vpu_probe.chain_plain(torch.from_numpy(a).to(tdt),
                                torch.from_numpy(b).to(tdt), CHAIN, width)
    assert got.dtype == tdt and tuple(got.shape) == SHAPE
    assert np.array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype,form,width", vpu_probe.VARIANTS,
                         ids=lambda v: str(v))
def test_chain_on_cpu_takes_plain_version(dtype, form, width):
    tdt = vpu_probe.DTYPES[dtype][0]
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-8, 9, (3, 7))).to(tdt)
    b = torch.from_numpy(rng.integers(-8, 9, (3, 7))).to(tdt)
    vpu_probe.reset_counts()
    got = vpu_probe.chain(a, b, 4, width, form)
    assert vpu_probe.plain_calls == 1
    assert vpu_probe.launches == {"probe_chain": 0, "probe_ilp": 0}
    assert torch.equal(got, vpu_probe.chain_plain(a, b, 4, width))


@pytest.mark.parametrize("args,match", [
    (("bfloat16", "plain", 8), "no kernel variant"),
    (("int32", "dpx", 1), "no kernel variant"),
    (("float32", "plain", 4), "no kernel variant"),
    (("float32", "x2", 8), "no kernel variant"),
])
def test_chain_refuses_variants_the_kernel_lacks(args, match):
    dtype, form, width = args
    x = torch.zeros((2, 4), dtype=vpu_probe.DTYPES[dtype][0])
    with pytest.raises(ValueError, match=match):
        vpu_probe.chain(x, x, 3, width, form)


def test_chain_checks_its_tensors():
    x = torch.zeros((2, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="unsupported dtype"):
        vpu_probe.chain(x.half(), x.half(), 3, 1)
    with pytest.raises(ValueError, match="must match"):
        vpu_probe.chain(x, x.int(), 3, 1)
    with pytest.raises(ValueError, match="must match"):
        vpu_probe.chain(x, x[:1], 3, 1)
    with pytest.raises(ValueError, match="contiguous"):
        vpu_probe.chain(x.t(), x.t(), 3, 1)
    with pytest.raises(ValueError, match="non-negative"):
        vpu_probe.chain(x, x, -1, 1)


def test_launcher_takes_only_cuda_tensors():
    x = torch.zeros((2, 4), dtype=torch.float32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        vpu_probe.launcher(x, x, 3, 8)


def test_ops_per_instruction():
    """Three ops a link over the fewest instructions a link can take: 3 for
    the float forms (float64's too), 2 for the integer ones; a packed pair
    does twice."""
    got = {v: vpu_probe.ops_per_instruction(v[0], v[1])
           for v in vpu_probe.VARIANTS}
    assert got == {
        ("float32", "plain", 1): 1, ("float32", "plain", 8): 1,
        ("int32", "plain", 1): 1.5, ("int32", "plain", 8): 1.5,
        ("int32", "dpx", 8): 1.5, ("int16", "plain", 1): 1.5,
        ("int16", "plain", 8): 1.5, ("int16", "dpx", 8): 3,
        ("bfloat16", "x2", 8): 2, ("float64", "plain", 8): 1,
    }


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _sass(struct, width, links):
    """A ``cuobjdump -sass`` listing of one chain_kernel instantiation
    whose loop runs ``links`` (lists of instructions) and branches back."""
    lines = ["\t\tFunction : _ZN45_GLOBAL__N__0_12_vpu_probe_cu_012chain_"
             f"kernelINS_{len(struct)}{struct}ELi{width}EEEvPKNT_1EES5_PS3_xi",
             "        /*0000*/                   LDC R1, c[0x0][0x28] ;"]
    body = [i for link in links for i in link] + [
        "VIADD R17, R17, 0xfffffffc", "ISETP.NE.AND P1, PT, R17, RZ, PT"]
    for k, ins in enumerate(body, 1):
        lines.append(f"        /*{16 * k:04x}*/                   {ins} ;")
    at = 16 * (len(body) + 1)
    lines += [f"        /*{at:04x}*/               @P1 BRA 0x10 ;",
              f"        /*{at + 16:04x}*/                   EXIT ;"]
    return "\n".join(lines)


DPX_LINK = ["VIADDMNMX R16, R16, R6.reuse, R5.reuse, !PT",
            "IMAD.IADD R16, R16, 0x1, -R7"]
IADD3_LINK = ["IADD3 R16, R6, R16, -R7", "VIMNMX R16, R5, R16, !PT"]
F32_LINK = ["FADD R2, R2, R6", "FMNMX R2, R2, R5, !PT", "FADD R2, R2, -R7"]
# a double max as a compare and two selects, between the two adds
F64_LINK = ["DADD R2, R2, R6", "DSETP.MAX.AND P0, P1, R2, R8, PT",
            "FSEL R2, R2, R8, P0", "FSEL R3, R3, R9, P0",
            "DADD R2, R2, -R10"]


@pytest.mark.parametrize("struct,variant,links,error", [
    ("I32Dpx", ("int32", "dpx", 8), [DPX_LINK] * 32, None),
    ("I32", ("int32", "plain", 8), [IADD3_LINK] * 32, None),
    ("F32", ("float32", "plain", 1), [F32_LINK] * 4, None),
    ("F64", ("float64", "plain", 8), [F64_LINK] * 32, None),
    # the fold ptxas made of the fused form: no subtract
    ("I32Dpx", ("int32", "dpx", 8), [DPX_LINK[:1]] * 32, "folded"),
    ("F32", ("float32", "plain", 1), [F32_LINK[1:]] * 4, "folded"),
    ("F64", ("float64", "plain", 8), [F64_LINK[1:]] * 32, "folded"),
    ("I32", ("int32", "plain", 8), [IADD3_LINK] * 8, "below 32"),
    ("I32", ("int32", "dpx", 8), [DPX_LINK] * 32, "no chain loop"),
], ids=["dpx", "iadd3", "f32", "f64", "dpx-folded", "f32-folded",
        "f64-folded", "few-maxes", "missing"])
def test_sass_check_fails_a_folded_chain(struct, variant, links, error):
    cs = _chip_smoke()
    loops = cs.sass_chain_loops(_sass(struct, variant[2], links))
    if error is None:
        cs.sass_check(loops, [variant], vpu_probe.OPS_PER_LINK)
        (loop,) = loops[variant]
        assert loop["maxes"] == len(links)
    else:
        with pytest.raises(RuntimeError, match=error):
            cs.sass_check(loops, [variant], vpu_probe.OPS_PER_LINK)


@pytest.mark.parametrize("call", [
    lambda: vpu_probe.vmem_ceiling(device="cpu"),
    lambda: vpu_probe.vpu_roofline(device="cpu"),
    lambda: vpu_probe.roofline_ops_per_sec("float32", device="cpu"),
    lambda: vpu_probe._ilp_rate("int32", device="cpu"),
    lambda: vpu_probe.elementwise_ceiling(device="cpu"),
    lambda: vpu_probe.fill_scaling(device="cpu"),
], ids=["vmem_ceiling", "vpu_roofline", "roofline_ops_per_sec", "_ilp_rate",
        "elementwise_ceiling", "fill_scaling"])
def test_measuring_functions_raise_on_cpu(call, capsys):
    vpu_probe.reset_counts()
    with pytest.raises(RuntimeError, match="measures the card"):
        call()
    assert "Tops/s" not in capsys.readouterr().out
    assert vpu_probe.plain_calls == 0


def test_main_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="measures the card"):
        vpu_probe.main(["--quick"])


def _fake_timer(seconds):
    """A timer that reports ``seconds[K]`` for a run of K units."""
    ks = []

    def run_k(K):
        ks.append(K)

    def timer(fn):
        fn()
        return seconds[ks[-1]]

    return run_k, timer, ks


def test_amortized_takes_the_difference():
    run_k, timer, _ = _fake_timer({1: 1.0, 5: 3.0})
    assert vpu_probe._amortized(run_k, timer=timer) == 0.5


def test_amortized_widens_once_on_a_non_positive_difference():
    run_k, timer, ks = _fake_timer({1: 1.0, 5: 0.9, 20: 2.9})
    assert vpu_probe._amortized(run_k, timer=timer) == pytest.approx(0.1)
    assert max(ks) == 20


def test_amortized_raises_when_the_widened_difference_is_non_positive():
    run_k, timer, ks = _fake_timer({2: 1.0, 12: 1.0, 48: 0.5})
    with pytest.raises(RuntimeError, match="non-positive twice"):
        vpu_probe._amortized(run_k, reps=3, k1=2, k2=12, timer=timer)
    assert sorted(set(ks)) == [2, 12, 48]

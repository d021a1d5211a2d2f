"""The host side of the float64 kernels, on the CPU: the constants header
the f64 instantiations are built with, the choice of each kernel library by
dtype, the dense route's and the fleet's decisions by device and dtype, and
the f64 bound. The kernels themselves run only on a card
(`tests/test_torch_f64_gpu.py`); their f64 plain versions are held against
the JAX package's f64 retry loop in `tests/test_torch_backward_retry.py`."""
import hashlib
import re
import types

import numpy as np
import pytest
import torch

from hkdmpc_tpu_torch.models import hkd_weights as W
from hkdmpc_tpu_torch.models import mini_cheetah as mc
from hkdmpc_tpu_torch.mpc import fleet
from hkdmpc_tpu_torch.ops import _build, counters, riccati_bound, riccati_dense
from hkdmpc_tpu_torch.ops import riccati_hkd
from hkdmpc_tpu_torch.solver import backward

# sha256 of the float32 part of the generated header (every line before the
# float64 constants), as the f32 kernels were built before the f64
# constants existed
F32_HEADER_SHA256 = ("bccb74f94f383a15af030e656e96cf096fa7243c74477ab95a1728a6"
                     "0a2647fc")
F64_MARK = "// the same values in float64 (the f64 kernels)\n"
DTYPES = (torch.float32, torch.float64, torch.float16, torch.bfloat16)


def _declared(header: str, prefix: str) -> dict:
    """{name: [values]} of the constants declared with `prefix`_ (the hex
    literals in order, a trailing f dropped)."""
    out = {}
    for line in header.splitlines():
        m = re.match(rf"(?:__constant__|constexpr) \w+ {prefix}_(\w+)\b.*= "
                     r"(.*);$", line)
        if m:
            lits = re.findall(r"-?0x[0-9a-f.]+p[+-]\d+f?", m.group(2))
            out[m.group(1)] = [float.fromhex(v.rstrip("f")) for v in lits]
    return out


def _flat(value) -> list:
    if not isinstance(value, list):
        return [float(value)]
    return [float(v) for x in value for v in _flat(x)]


def test_constants_header_f32_part_is_unchanged():
    """The float32 constants, byte for byte as the f32 kernels had them,
    come first; the float64 ones follow."""
    h = _build.constants_header()
    f32, f64 = h.split(F64_MARK)
    assert hashlib.sha256(f32.encode()).hexdigest() == F32_HEADER_SHA256
    assert "KD_" not in f32 and "double" not in f32
    assert " K_" not in f64 and "float " not in f64


@pytest.mark.parametrize("prefix,cast", [
    ("K", lambda v: float(np.float32(v))), ("KD", float)], ids=["f32", "f64"])
def test_constants_header_values_are_exact(prefix, cast):
    """Every constant, in both types, is the exact value of the Python
    number (float32: rounded once; float64: as it is), in the table's
    order, and the model modules' values are what the table holds."""
    got = _declared(_build.constants_header(), prefix)
    table = _build.constant_values()
    assert list(got) == [name for name, _ in table]
    for name, value in table:
        assert got[name] == [cast(v) for v in _flat(value)], name
    table = dict(table)
    assert table["IINV"] == list(mc.INERTIA_INV_DIAG)
    assert table["QF"] == [W.QF_MULT * s * q for s, q in
                           zip(W.QF_SCALE_BODY, W.Q_BODY)]
    assert table["INV_MASS"] == 1.0 / mc.MASS
    assert table["MU2"] == W.MU_FRICTION * W.MU_FRICTION


def test_kernel_entry_points_by_dtype():
    """A kernel's one library holds both instantiations: float32 runs its
    `<name>_launch` / `<name>_info`, float64 `<name>_launch_f64` /
    `<name>_info_f64`, each a C entry point of the kernel's source; any
    other dtype has no entry point, and the error names the kernel and the
    types it takes."""
    for name in ("riccati_hkd", "riccati_dense", "linear_rollout_hkd"):
        text = (_build.CSRC / f"{name}.cu").read_text()
        for fn in ("launch", "info"):
            f32 = _build.entry(name, fn, torch.float32)
            f64 = _build.entry(name, fn, torch.float64)
            assert (f32, f64) == (f"{name}_{fn}", f"{name}_{fn}_f64")
            for sym in (f32, f64):
                assert f'extern "C" int {sym}(' in text, sym
            for half in (torch.float16, torch.bfloat16):
                with pytest.raises(TypeError,
                                   match=f"{name}.*float32 or float64"):
                    _build.entry(name, fn, half)
        assert "RICCATI_F64" not in text


def _expected_route(device, dtype, width, lux):
    if device != "cuda":
        return "scan" if lux else "kernel"
    if dtype not in (torch.float32, torch.float64) or width != 24:
        return NotImplementedError
    return ValueError if lux else "kernel"


@pytest.mark.parametrize("lux", [False, True], ids=["no_lux", "lux"])
@pytest.mark.parametrize("width", [24, 12])
@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_dense_route_decision(device, dtype, width, lux):
    """The dense route by (device type, dtype, width, cross term): on the
    CPU the kernel's plain version, or the scan sweep for a cross term; on
    CUDA the kernel for 24-wide float32 and float64, and a refusal that
    names the routes that exist for anything else."""
    want = _expected_route(device, dtype, width, lux)
    route = lambda: backward.dense_route(device, dtype, (width, width),
                                         (width, width), lux)
    if isinstance(want, str):
        assert route() == want
    else:
        with pytest.raises(want, match="scan_backward=True"):
            route()
    t = types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                              shape=(2, 5, width, width))
    lq = types.SimpleNamespace(A=t, B=t, lux=object() if lux else None)
    if isinstance(want, str):
        assert backward._dense_route(lq) == want
    else:
        with pytest.raises(want):
            backward._dense_route(lq)


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: str(d)[6:])
@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fleet_kernel_jac_default(device, dtype):
    """FleetConfig(kernel_jac=None): K1 on CUDA in float32 and float64, the
    dense path elsewhere."""
    want = device == "cuda" and dtype in (torch.float32, torch.float64)
    assert fleet.default_kernel_jac(device, dtype) is want


def test_fleet_resolves_its_default_from_the_rule(tmp_path):
    """A fleet built with the default config takes default_kernel_jac's
    answer (on the CPU: the dense path, in f64 as in f32)."""
    from hkdmpc_tpu_torch.workload import gait_file
    ref = gait_file("trot", str(tmp_path))
    for dtype in (torch.float32, torch.float64):
        f = fleet.FleetMPC(ref, 2, dtype=dtype, device="cpu")
        assert f._kernel_jac is fleet.default_kernel_jac("cpu", dtype)


def _kinds():
    """The trot's schedule (60 DYN, 4 RESET, 11 PAD) at B = 4096 and the
    2.0 s plan's (T = 250) at B = 256."""
    trot = np.zeros((4096, 75), np.int32)
    trot[:, :60], trot[:, 60:64] = 1, 2
    long = np.zeros((256, 250), np.int32)
    long[:, :200], long[:, 200:219] = 1, 2
    return {"trot": (trot, 75, 76), "T250": (long, 250, 251)}


@pytest.mark.parametrize("case", ["trot", "T250"])
def test_f64_bound_doubles_the_float_bytes(case):
    """The f64 sweep moves twice the float bytes of the f32 one and the
    same int and bool bytes, with the same operations; the f32 counts are
    those the f32 kernels were measured against."""
    kind, u_rows, ur_rows = _kinds()[case]
    rb = riccati_bound
    for work in (lambda r: rb.hkd_sweep_work(kind, u_rows, ur_rows, r),
                 lambda r: rb.dense_sweep_work(kind, r)):
        w32, w64 = work(rb.F32), work(rb.F64)
        assert w64["float_bytes"] == 2 * w32["float_bytes"]
        assert (w64["bytes"] - w64["float_bytes"]
                == w32["bytes"] - w32["float_bytes"] > 0)
        assert w64["flops"] == w32["flops"]
    assert rb.hkd_sweep_work(kind, u_rows, ur_rows) == rb.hkd_sweep_work(
        kind, u_rows, ur_rows, rb.F32)
    assert rb.dense_sweep_work(kind) == rb.dense_sweep_work(kind, rb.F32)
    if case == "trot":
        assert rb.hkd_sweep_work(kind, 75, 76)["bytes"] == 982716416
        assert rb.dense_sweep_work(kind)["bytes"] == 3162755072


def test_f64_bound_uses_the_fp64_peak():
    """The f64 bound divides the operations by the card's FP64 tensor-core
    rate (67 TFLOP/s, the least time; the vector units' 34 TFLOP/s named
    beside it) and the bytes by its memory rate; at B = 4096 on the trot
    both f64 sweeps are bound by bytes."""
    rb = riccati_bound
    kind, u_rows, ur_rows = _kinds()["trot"]
    assert rb.H100_F64_FLOP_PER_S == 67e12
    assert rb.H100_F64_VECTOR_FLOP_PER_S == 34e12
    for w in (rb.hkd_sweep_work(kind, u_rows, ur_rows, rb.F64),
              rb.dense_sweep_work(kind, rb.F64)):
        b = rb.bound_ms(w)
        assert b["operations_ms"] == w["flops"] / 67e12 * 1e3
        assert b["bytes_ms"] == w["bytes"] / 3.35e12 * 1e3
        assert b["bound_by"] == "bytes"
        assert b["bound_ms"] == b["bytes_ms"]
        vector = rb.bound_ms(w, flop_per_s=rb.H100_F64_VECTOR_FLOP_PER_S)
        assert vector["operations_ms"] == w["flops"] / 34e12 * 1e3


def test_f64_launch_counters_fold_with_the_programs():
    """Both kernels count their f64 launches apart (beside the counts of
    both dtypes), and a device program's runs fold into them."""
    for module in (riccati_hkd, riccati_dense):
        for name in ("LAUNCHES_F64", "RETRY_LAUNCHES_F64"):
            assert (module, name) in counters.REGISTRY
            before = getattr(module, name)
            setattr(module, name, before + 3)
            assert getattr(module, name) == before + 3
            setattr(module, name, before)
    assert _build.KERNEL_DTYPES == (torch.float32, torch.float64)

"""Build and load the port's CUDA kernels, and its one host-only native
library (`build_host`: the transport, csrc/hkdcomm.cpp, with g++), at first
use.

The sources live in `hkdmpc_tpu_torch/csrc/`: one `<name>.cu` per kernel,
with a plain C interface (`<name>_launch`, `<name>_info`,
`<name>_error_string`; `library`), the native assembly of the while graphs
(`graph_while.cu`, whose caller sets its own signatures; `load`), and the
`*.cuh` headers they include. `nvcc` compiles each `<name>.cu` for Hopper
(`sm_90a`) into its own shared library, loaded with ctypes, in
`build/hkdmpc_tpu_torch/` beside the package. The HKD constants and cost
weights are not typed into the sources: this module writes them from
`models/mini_cheetah.py` and `models/hkd_weights.py` into a generated header,
`hkd_constants.cuh`, in the build directory. Each library is keyed on a hash
of its source, of every header it includes (followed transitively), of the
generated header where it is included, and of the compiler flags, so a
change to any of them rebuilds it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import torch

from hkdmpc_tpu_torch.models import hkd_weights as W
from hkdmpc_tpu_torch.models import mini_cheetah as mc

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "hkdmpc_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
GXX_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared", "-pthread")
GENERATED_HEADER = "hkd_constants.cuh"
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)

# ctypes signature of each kernel's `<name>_launch`: the tensor pointers,
# then the int sizes, then the stream
_LAUNCH_ARGTYPES = {
    "riccati_hkd": [ctypes.c_void_p] * 25 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p],
    "riccati_dense": [ctypes.c_void_p] * 18 + [ctypes.c_int] * 2
                     + [ctypes.c_void_p],
}

_LIBS: dict = {}
_SIGNED: set = set()   # kernels whose launch signatures are set


def _f32(v) -> str:
    """Exact float32 literal (hex) of a Python/numpy number."""
    return float(np.float32(v)).hex() + "f"


def _arr(vals) -> str:
    return "{" + ", ".join(_f32(v) for v in vals) + "}"


def constants_header() -> str:
    """The kernels' constants, as float32 values of the Python model and
    weight modules (derived products are taken in float64 first, as the
    Python code forms them)."""
    qf = [W.QF_MULT * s * q for s, q in zip(W.QF_SCALE_BODY, W.Q_BODY)]
    lines = [
        "// Generated by hkdmpc_tpu_torch/ops/_build.py from",
        "// hkdmpc_tpu_torch/models/mini_cheetah.py and hkd_weights.py.",
        "#pragma once",
        f"__constant__ float K_IINV[3] = {_arr(mc.INERTIA_INV_DIAG)};",
        f"__constant__ float K_IDIAG[3] = {_arr(mc.INERTIA_DIAG)};",
        "__constant__ float K_HIP[4][3] = {"
        + ", ".join(_arr(row) for row in mc.HIP_OFFSETS) + "};",
        "__constant__ float K_L1S[4] = "
        + _arr([mc.ABAD_LINK * float(s) for s in mc.SIDE_SIGNS]) + ";",
        f"__constant__ float K_Q_BODY[12] = {_arr(W.Q_BODY)};",
        f"__constant__ float K_QF[12] = {_arr(qf)};",
        f"__constant__ float K_WFOOT[2] = {_arr(W.FOOTREG_W[:2])};",
        f"constexpr float K_INV_MASS = {_f32(1.0 / mc.MASS)};",
        f"constexpr float K_L2 = {_f32(mc.THIGH_LINK)};",
        f"constexpr float K_L3 = {_f32(mc.SHANK_LINK)};",
        f"constexpr float K_Q_SWING_LEG = {_f32(W.Q_SWING_LEG)};",
        f"constexpr float K_QF_LEG = "
        f"{_f32(W.QF_MULT * W.QF_SCALE_LEG * W.Q_SWING_LEG)};",
        f"constexpr float K_R_GRF = {_f32(W.R_GRF)};",
        f"constexpr float K_R_QJD = {_f32(W.R_QJD)};",
        f"constexpr float K_TF2 = {_f32(2.0 * W.FOOTREG_TERM_FACTOR)};",
        f"constexpr float K_MU = {_f32(W.MU_FRICTION)};",
        f"constexpr float K_MU2 = {_f32(W.MU_FRICTION * W.MU_FRICTION)};",
    ]
    return "\n".join(lines) + "\n"


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
            "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""]:
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                       "to build the CUDA kernels")


def included_files(src: Path) -> list:
    """The headers `src` includes with `#include "..."`, followed
    transitively, as paths in src's directory (the generated header
    excepted), sorted."""
    seen, todo = set(), [src]
    while todo:
        for name in _INCLUDE.findall(todo.pop().read_text()):
            path = src.parent / name
            if name != GENERATED_HEADER and path not in seen:
                if not path.is_file():
                    raise FileNotFoundError(f"{src.name} includes {name}, "
                                            f"which is not in {src.parent}")
                seen.add(path)
                todo.append(path)
    return sorted(seen)


def uses_generated_header(src: Path) -> bool:
    return any(GENERATED_HEADER in _INCLUDE.findall(p.read_text())
               for p in [src] + included_files(src))


def build_key(src: Path) -> str:
    """Hash of the source, every header it includes, the generated header
    (when included) and the compiler flags."""
    h = hashlib.sha256(src.read_bytes())
    for path in included_files(src):
        h.update(path.name.encode() + b"\0" + path.read_bytes())
    if uses_generated_header(src):
        h.update(constants_header().encode())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(name: str, out_dir: Path, cmd: list) -> Path:
    """Run the compiler command `cmd` (complete but for its output) into a
    temporary name in out_dir and move the result to `lib<name>.so`, so a
    library that exists is whole; the compiler's output goes to
    `<name>.build.log` beside it. Raises on a failed build."""
    lib = out_dir / f"lib{name}.so"
    tmp = out_dir / f"lib{name}.so.tmp{os.getpid()}"
    cmd = cmd + ["-o", str(tmp)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / f"{name}.build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"{cmd[0]} failed on {name} (exit "
                           f"{proc.returncode}):\n" + proc.stdout
                           + proc.stderr)
    os.replace(tmp, lib)
    return lib


def build(name: str) -> Path:
    """Compile csrc/<name>.cu (if its keyed library is not built yet) and
    return the path of the shared library. The compiler's output, with
    ptxas's register and shared-memory report, goes to `<name>.build.log`
    beside it."""
    src = CSRC / f"{name}.cu"
    out_dir = BUILD_DIR / build_key(src)
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    if uses_generated_header(src):
        (out_dir / GENERATED_HEADER).write_text(constants_header())
    return _compile(name, out_dir, [_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v",
                                    "-I", str(out_dir), str(src)])


def build_host(name: str) -> Path:
    """Compile the host-only source csrc/<name>.cpp with g++ (if its keyed
    library is not built yet) into the build directory and return the path
    of the shared library. The key hashes the source and the flags."""
    src = CSRC / f"{name}.cpp"
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    out_dir = BUILD_DIR / h.hexdigest()[:16]
    lib = out_dir / f"lib{name}.so"
    if lib.exists():
        return lib
    gxx = shutil.which("g++")
    if gxx is None:
        raise RuntimeError(f"g++ not found on PATH: it builds {src.name}")
    out_dir.mkdir(parents=True, exist_ok=True)
    return _compile(name, out_dir, [gxx, *GXX_FLAGS, str(src)])


def load(name: str) -> ctypes.CDLL:
    """The library of csrc/<name>.cu, built and loaded once per process;
    the caller sets the ctypes signatures of what it calls."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build(name)))
        _LIBS[name] = lib
    return lib


def library(name: str) -> ctypes.CDLL:
    """Kernel `name`'s library, built and loaded once per process, with the
    ctypes signatures of `<name>_launch` and `<name>_error_string` set."""
    lib = load(name)
    if name not in _SIGNED:
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = _LAUNCH_ARGTYPES[name]
        fn.restype = ctypes.c_int
        info = getattr(lib, f"{name}_info")
        info.argtypes = [ctypes.POINTER(ctypes.c_int)] * 3
        info.restype = ctypes.c_int
        errstr = getattr(lib, f"{name}_error_string")
        errstr.argtypes = [ctypes.c_int]
        errstr.restype = ctypes.c_char_p
        _SIGNED.add(name)
    return lib


def launch(name: str, *args) -> None:
    """Call `<name>_launch(*args)` and raise if it returns a non-zero
    cudaError_t (a refused launch never runs, and a later synchronize does
    not report it)."""
    err = getattr(library(name), f"{name}_launch")(*args)
    if err != 0:
        _raise_cuda(name, "kernel launch", err)


def _raise_cuda(name: str, what: str, err: int) -> None:
    msg = getattr(library(name), f"{name}_error_string")(err).decode()
    raise RuntimeError(f"{name} {what} failed: cudaError {err} ({msg})")


def kernel_info(name: str) -> dict:
    """How kernel `name` sits on the current CUDA device: threads per block,
    dynamic shared memory per block in bytes, and the blocks of it that one
    SM holds at a time (`<name>_info`)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    err = getattr(library(name), f"{name}_info")(*map(ctypes.byref, vals))
    if err != 0:
        _raise_cuda(name, "occupancy query", err)
    return dict(zip(("threads_per_block", "smem_bytes", "blocks_per_sm"),
                    (v.value for v in vals)))


def check_tensor(name, t, shape, dtype, device, align=1) -> None:
    """Raise unless t is a contiguous tensor of `shape` and `dtype` on
    `device` whose first byte lies on a multiple of `align` (TypeError for
    type, ValueError for the rest)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name}: data pointer {t.data_ptr():#x} is not "
                         f"{align}-byte aligned")


def outputs(out, active, spec, device) -> tuple:
    """A sweep's output tensors: new ones (`torch.empty`) for a first sweep
    (`out` and `active` None), or a retry's `out`, the first sweep's
    outputs, checked against `spec` ((name, shape, dtype), ...) beside its
    `active` mask ((B,) bool)."""
    if (out is None) != (active is None):
        raise ValueError("a retry sweep takes both active= and out=, a "
                         "first sweep neither")
    if out is None:
        return tuple(torch.empty(shape, dtype=dtype, device=device)
                     for _, shape, dtype in spec)
    check_tensor("active", active, spec[-1][1], torch.bool, device)
    if len(out) != len(spec):
        raise ValueError(f"out: {len(out)} tensors, expected {len(spec)}")
    for t, (name, shape, dtype) in zip(out, spec):
        check_tensor(name, t, shape, dtype, device)
    return tuple(out)

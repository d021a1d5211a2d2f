"""The device programs' engine: the port's counterpart of the JAX package's
jit cache. The programs themselves live with their callers: the solve's
(`ddp.SolveProgram`, replayed by `ddp.replay_solve`, `ddp.solve_batch` on
CUDA) and the MPC step's (`fused.StepProgram`, `fused.replay_step`,
`fused.fleet_step` on CUDA, with the state donated). This module knows
neither, nor any kernel by name.

JAX compiles each entry point once per static key and runs it as one
device program, its `lax.while_loop`s included. Here each entry point is
built once per key into one CUDA graph and replayed (`replay`):

- the key: the caller's (its static flags, its inputs' layout, the
  addresses of what it reads and writes in place);
- the pieces: a `Program` names its pieces, each reading and writing
  static buffers and setting its loop's device flag, and the order that
  runs them (`code`);
- the build: a warm-up run of each piece on the capture stream (it builds
  and loads the kernels, makes every cached constant and the cuBLAS
  handles), then one torch capture of each piece on that stream in
  "thread_local" mode (a capture in the MPC service's worker thread leaves
  the polling thread free), all into one memory pool per device; then
  `csrc/graph_while.cu` assembles the pieces in the program's order: each
  piece a child graph node, as often as the order names it, each loop a
  conditional while node;
- a replay: the inputs are copied into the static buffers (host arrays
  through pinned staging buffers, copied without blocking, `HostInput`),
  then the program is launched on the caller's current stream. Nothing is
  read on the host: each piece counts its runs in a device tensor, and
  `fold_counts` adds them, times the kernel launches each piece recorded
  at capture, to the kernels' counters (every counter that a kernel
  wrapper declares to `ops/counters.install`, `counters.REGISTRY`) when a
  counter is read or `stats()` is called.

The stage clock: every program carries a device buffer with its runs
(`StageClock`). A one-thread lap kernel (`csrc/graph_while.cu`) at the end
of each stage of a piece and of each piece reads the device's
%globaltimer and adds the time since the last lap to that stage (`STAGES`),
so the stages of a replay sum to its device time; the lap at a piece's end
also counts the piece's run. Each replay leaves a row in a ring of
`RING_ROWS`, read in the same host read as the runs.
`stats()` gives each program's median stage and device ms over its ring;
`replay_records` the rows on the host clock (the offset between the two
clocks measured by a stamp kernel between two host reads, `clock_offset`);
`outside_program` the device time between consecutive replays, split by
the host span (`utils.spans`) open at each instant.

A capture or an assembly that fails raises RuntimeError naming the
operation or the node; nothing falls back to eager. `clear_graphs()` frees
every graph, as `jax.clear_caches` frees the compiled programs. A reset of
an MPC object copies its new tables and state into the resident ones
(`rearm`), so the step programs keyed on their addresses replay on;
tensors replaced for good take their graphs with them (`forget`).
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import threading
import time
import traceback

import numpy as np
import torch

from hkdmpc_tpu_torch.ops import _build, counters
from hkdmpc_tpu_torch.utils import spans

REPLAYS = 0          # every replay of every graph

# the stages a program's clock splits a replay into: the nominal and the
# line search's rollouts; cost, feasibility and violations; the dense
# route's LQ approximation; the backward sweep (first sweep, retries,
# finish); the linear rollout; a step's `pre` and `post`; everything else
STAGES = ("rollout", "cost", "lq", "backward", "linear_rollout", "step_io",
          "other")
RING_ROWS = 1024     # replays a program's clock keeps
ALIGN_NS = 50_000    # the offset's uncertainty above which gaps go unlabelled
OFFSET_TRIES = 8     # stamps a reading of the clock offset takes the best of
_OFFSETS: dict = {}  # device -> deque of (host ns, offset ns, uncertainty)

_GRAPHS: dict = {}   # key -> _Graph
_POOLS: dict = {}    # device -> memory pool handle shared by the graphs
_STREAMS: dict = {}  # device -> the side stream of every capture
_LOCK = threading.RLock()   # one capture at a time in the process


def leaves(tree) -> list:
    """The tensors of a (nested) struct dataclass, dict, tuple or list, in
    order; None and bools (host-side notes) are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    elif tree is None or isinstance(tree, bool):
        return []
    return [t for item in tree for t in leaves(item)]


def layout(tensors) -> tuple:
    """The shapes and dtypes of `tensors`, for a program's key."""
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _counts() -> dict:
    """{(module, name): value} of every installed counter."""
    return {c: counters.raw(*c) for c in counters.REGISTRY}


def _set_counts(values) -> None:
    for c, v in values.items():
        counters.set_raw(*c, v)


def _node_count(graph):
    """Nodes of the captured graph (`cuGraphGetNodes` of libcuda), or None
    where this torch does not keep the graph."""
    try:
        raw = graph.raw_cuda_graph()
        lib = ctypes.CDLL("libcuda.so.1")
    except (AttributeError, RuntimeError, OSError):
        return None
    n = ctypes.c_size_t(0)
    err = lib.cuGraphGetNodes(ctypes.c_void_p(raw), None, ctypes.byref(n))
    return int(n.value) if err == 0 else None


def _offending_frame(exc) -> str:
    """'file:line in function: source' of the innermost frame of this
    package in exc's traceback."""
    frames = [f for f in traceback.extract_tb(exc.__traceback__)
              if "hkdmpc_tpu_torch" in f.filename]
    if not frames:
        return "outside this package"
    f = frames[-1]
    return f"{f.filename}:{f.lineno} in {f.name}: {(f.line or '').strip()}"


def _capture_error(label, exc):
    """The exception to raise for a capture that failed with exc: the
    body's error where capture_end's own error followed it; a CUDA error,
    named with the operation that raised it, as RuntimeError; any other
    exception (a refused argument) as it is."""
    first = exc
    if exc.__context__ is not None and "captur" in str(exc).lower():
        first = exc.__context__
    if not isinstance(first, RuntimeError):
        return first
    return RuntimeError(f"CUDA graph capture of {label} failed at "
                        f"{_offending_frame(first)} -- {first}")


@dataclasses.dataclass
class _Graph:
    label: str
    graph: object
    inputs: list          # static input buffers, in the order of the key
    outputs: object       # static outputs (a tree)
    launches: dict        # {counter: launches} of the last replay
    capture_s: float
    nodes: object
    keep: tuple = ()      # objects the key names by identity
    host_inputs: tuple = ()
    replays: int = 0
    addresses: frozenset = frozenset()   # data_ptr()s the key names
    pieces: tuple = ()          # _Piece per captured piece
    native_nodes: tuple = ()    # native nodes per graph level
    assembly_s: float = 0.0
    assembly_bytes: int = 0
    folded: list = dataclasses.field(default_factory=list)  # runs folded
    folded_replays: int = 0
    last_runs: tuple = ()       # each piece's runs in the last replay
    clock: object = None        # the stage clock as last read (numpy)


class HostInput:
    """A graph input that arrives from the host: a static device buffer fed
    from a pinned staging buffer without blocking. Before the staging
    buffer is written again, the copy out of it must have run (an event)."""

    def __init__(self, shape, dtype, device):
        self.device_buf = torch.empty(shape, dtype=dtype, device=device)
        self.host_buf = torch.empty(shape, dtype=dtype, pin_memory=True)
        self.copied = None

    def load(self, value) -> None:
        if isinstance(value, torch.Tensor) and value.device.type == "cuda":
            self.device_buf.copy_(value)
            return
        if self.copied is not None:
            self.copied.synchronize()
        if isinstance(value, torch.Tensor):
            self.host_buf.copy_(value)
        else:
            self.host_buf.numpy()[...] = np.asarray(value).reshape(
                self.host_buf.shape)
        self.device_buf.copy_(self.host_buf, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()


def _pool(device):
    if device not in _POOLS:
        _POOLS[device] = torch.cuda.graph_pool_handle()
    return _POOLS[device]


def _capture_stream(device):
    """The one side stream of `device` that every warm-up and capture
    takes: the allocator reuses a freed block only on the stream it was
    used on, so one stream lets a capture reuse the pool memory that the
    intermediates of earlier captures freed (their replays never overlap:
    each goes to its caller's current stream)."""
    if device not in _STREAMS:
        _STREAMS[device] = torch.cuda.Stream(device=device)
    return _STREAMS[device]


def _capture(label, device, body) -> tuple:
    """Capture `body()` on the capture stream of `device` into a graph that
    torch keeps uninstantiated (the program's assembly clones it). Returns
    (graph, launches recorded, capture seconds, nodes)."""
    stream = _capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    before = _counts()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    caller_stream = torch.cuda.current_stream(device)
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, pool=_pool(device), stream=stream,
                              capture_error_mode="thread_local"):
            body()
    except Exception as exc:
        # a failed capture_end leaves the capture stream current, and the
        # allocator still recording to the pool: later captures take a
        # new pool (the graphs already captured keep theirs)
        torch.cuda.set_stream(caller_stream)
        _POOLS.pop(device, None)
        err = _capture_error(label, exc)
        if err is exc:
            raise
        raise err from exc
    finally:
        after = _counts()
        recorded = {c: v - before.get(c, 0) for c, v in after.items()}
        # a capture launches nothing
        _set_counts({c: before.get(c, 0) for c in after})
    return graph, recorded, time.perf_counter() - t0, _node_count(graph)


def _same_view(a, b) -> bool:
    return (a.data_ptr() == b.data_ptr() and a.shape == b.shape
            and a.stride() == b.stride() and a.dtype == b.dtype)


def _storage(t) -> int:
    return t.untyped_storage().data_ptr()


def _pairs(dst, src) -> list:
    """(destination, source) leaves of two structs of one layout, without
    the sources that are their destination (a piece wrote them in place);
    a source that shares memory with a destination leaf is cloned, so
    nothing read has been written before."""
    mem = {_storage(d) for d in leaves(dst)}
    return [(d, t.clone() if _storage(t) in mem else t)
            for d, t in zip(leaves(dst), leaves(src)) if not _same_view(d, t)]


def write(dst, src) -> None:
    """Copy the struct `src` into the static struct `dst`, leaf by leaf."""
    pairs = _pairs(dst, src)
    if pairs:
        torch._foreach_copy_([d for d, _ in pairs], [t for _, t in pairs])


def write_where(dst, pred, src) -> None:
    """dst = tree_where(pred, src, dst) in place: pred (B,) bool picks
    src's lane where true, as `structs.tree_where`, into dst's buffers."""
    for d, t in _pairs(dst, src):
        p = pred.reshape(pred.shape + (1,) * (d.dim() - pred.dim()))
        torch.where(p, t, d, out=d)


def own(tree, others):
    """tree with each leaf that shares memory with `others` (a struct) or
    with an earlier leaf of tree cloned: a piece's outputs made fit to be
    a program's static buffer."""
    seen = {_storage(t) for t in leaves(others)}
    out = []
    for t in leaves(tree):
        out.append(t.clone() if _storage(t) in seen else t)
        seen.add(_storage(t))
    return rebuild(tree, out)


def like(tree):
    """Static buffers of tree's layout (`torch.empty_like` per leaf)."""
    return rebuild(tree, [torch.empty_like(t) for t in leaves(tree)])


class StageClock:
    """The meter of a program: one int64 buffer on the program's device
    (`meter`), one host read for all of it. `runs` (2, n_pieces): each
    piece's runs since the program was made (row 0) and in its last replay
    (row 1); `buf` (1 + RING_ROWS, 2 + len(STAGES)), the stage clock. Its
    row 0: replays begun, the last stamp, the laps run per stage; row
    1 + k % RING_ROWS: replay k's first and last stamp and its ns per
    stage. `start()` begins a replay (and zeroes `runs` row 1),
    `lap(stage, piece)` ends a stage and, given a piece, counts a run of
    it (one node for both): on a CUDA device a one-thread kernel that reads %globaltimer
    (`csrc/graph_while.cu`), launched on the current stream, so a capture
    records it as a node; on the CPU the same bookkeeping on the host
    clock (`time.time_ns`). A lap writes only the meter."""

    def __init__(self, n_pieces, device):
        n = 2 * n_pieces
        self.n_pieces = n_pieces
        self.meter = torch.zeros(n + (1 + RING_ROWS) * (2 + len(STAGES)),
                                 dtype=torch.int64, device=device)
        self.runs = self.meter[:n].view(2, n_pieces)
        self.buf = self.meter[n:].view(1 + RING_ROWS, 2 + len(STAGES))
        self.on_card = self.meter.device.type == "cuda"
        self._count = self._prev = 0     # the host clock's own head

    def start(self) -> None:
        self._lap(-1, -1)

    def lap(self, stage, piece=-1) -> None:
        self._lap(STAGES.index(stage), piece)

    def zero(self) -> None:
        self.meter.zero_()
        self._count = self._prev = 0

    def _lap(self, s, piece) -> None:
        if self.on_card:
            stream = torch.cuda.current_stream(self.meter.device).cuda_stream
            err = _clock_lib().stage_lap_launch(
                ctypes.c_void_p(self.meter.data_ptr()), self.n_pieces,
                piece, s, len(STAGES), RING_ROWS, ctypes.c_void_p(stream))
            if err != 0:
                raise RuntimeError(f"stage_lap launch failed: cudaError "
                                   f"{err}")
            return
        t = time.time_ns()
        buf = self.buf
        if s < 0:
            self.runs[1].zero_()
            row = 1 + self._count % RING_ROWS
            self._count += 1
            buf[row].zero_()
            buf[row, 0] = t
            buf[0, 0] = self._count
        else:
            row = 1 + max(self._count - 1, 0) % RING_ROWS
            buf[row, 2 + s] += t - self._prev
            buf[0, 2 + s] += 1
            if piece >= 0:
                self.runs[:, piece] += 1
        buf[row, 1] = buf[0, 1] = self._prev = t

    def read(self):
        """The stage clock on the host (a host read), as numpy."""
        return self.buf.cpu().numpy()


def ring(clock) -> list:
    """(replay index, row) of each replay a stage clock (a host copy of
    its buffer) still holds, oldest first; a row is (first stamp, last
    stamp, ns per stage)."""
    n = int(clock[0, 0])
    first = max(0, n - RING_ROWS)
    return [(k, clock[1 + k % RING_ROWS]) for k in range(first, n)]


def stage_summary(clock) -> tuple:
    """(median ms per stage, median device ms) over the replays a stage
    clock's host copy holds, or (None, None) where it holds none."""
    rows = np.array([r for _, r in ring(clock)], dtype=np.int64)
    if not len(rows):
        return None, None
    ms = np.median(rows[:, 2:], axis=0) / 1e6
    return (dict(zip(STAGES, ms.tolist())),
            float(np.median(rows[:, 1] - rows[:, 0]) / 1e6))


class Program:
    """Pieces on static buffers and the order that runs them. A subclass
    names its pieces (`PIECES`: a method `_<name>` each, reading and
    writing only static buffers) and its loops' device flags (`FLAGS`),
    and sets the buffers and `code`, the order: a list of items, each a
    piece's name or (flag, [items]), a while loop on that device flag;
    `_init` makes the flags and the meter (`StageClock`: `clock`, and its
    `runs`, each piece's runs since the program was made, row 0, and in its
    last run, row 1, counted on the device). The program's first piece
    begins a replay on the clock; each piece ends with a lap that counts
    its run and ends its last stage (`PIECE_STAGE`, else "other").
    `stats()` reports the runs of `ITERATION_PIECES` in a replay as its
    iterations and those of `RETRY_PIECE` as its retries.

    `run_on_host` drives the pieces in `code`'s order and reads each flag
    on the host where a while node would test it: on the CPU the tests
    do, and it is the device program's semantics (`build_program`)."""

    PIECES: tuple = ()
    FLAGS: tuple = ()
    PIECE_STAGE: dict = {}
    ITERATION_PIECES: tuple = ()
    RETRY_PIECE = None

    def _meter(self, dev) -> None:
        """The runs and the stage clock (`StageClock`, made once)."""
        if getattr(self, "clock", None) is not None:
            return
        self.clock = StageClock(len(self.PIECES), dev)
        self.meter, self.runs = self.clock.meter, self.clock.runs

    def _init(self, dev, code) -> None:
        self.flag = {n: torch.zeros((), dtype=torch.bool, device=dev)
                     for n in self.FLAGS}
        self._meter(dev)
        self.code = code
        self.warming = False
        # set while the pieces are captured: a piece that is its buffer's
        # only writer keeps its captured outputs as that buffer
        self.adopt = False

    def run(self, name) -> None:
        """Run one piece: its body, then its lap, which counts it (the
        program's first piece begins a replay on the clock first, which
        zeroes the counts of the last run)."""
        i = self.PIECES.index(name)
        if i == 0:
            self.clock.start()
        getattr(self, "_" + name)()
        self.clock.lap(self.PIECE_STAGE.get(name, "other"), i)

    def warm_up(self) -> None:
        """Each piece once, in order (the kernels, constants and handles a
        capture needs are made in a first run); a step writes nothing over
        its resident state here. The counts and the clock start again at
        0."""
        self.warming = True
        try:
            for name in self.PIECES:
                self.run(name)
        finally:
            self.warming = False
        self.clock.zero()

    def run_on_host(self, guard=contextlib.nullcontext) -> None:
        """The program on the host: each piece in `code`'s order inside
        `guard()`, each while loop's flag read between pieces."""
        def run(items):
            for item in items:
                if isinstance(item, str):
                    with guard():
                        self.run(item)
                else:
                    flag, body = item
                    while bool(self.flag[flag]):
                        run(body)
        run(self.code)

    def counts(self, row=0) -> dict:
        """{piece: runs} since the program was made (row 0) or in its last
        run (row 1) (a host read)."""
        return dict(zip(self.PIECES, self.runs[row].tolist()))


@dataclasses.dataclass
class _Piece:
    name: str
    graph: object         # torch.cuda.CUDAGraph, kept: its pool memory
    launches: dict        # {counter: launches} recorded at capture
    capture_s: float
    nodes: object


@functools.cache
def _program_lib():
    """The native assembly of the device programs (csrc/graph_while.cu),
    built and loaded at first use."""
    lib = _build.load("graph_while")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.graph_program_build.argtypes = [
        ctypes.POINTER(vp), ci, ctypes.POINTER(vp), ci,
        ctypes.POINTER(ci), ci, ctypes.POINTER(vp), ctypes.POINTER(ci), ci,
        ctypes.c_char_p, ci]
    lib.graph_program_build.restype = ci
    lib.graph_while_launch.argtypes = [vp, vp]
    lib.graph_while_launch.restype = ci
    lib.graph_while_destroy.argtypes = [vp]
    lib.graph_while_destroy.restype = ci
    lib.graph_while_error_string.argtypes = [ci]
    lib.graph_while_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def _clock_lib():
    """The stage clock's lap and stamp kernels, in the same native library
    (csrc/graph_while.cu)."""
    lib = _build.load("graph_while")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.stage_lap_launch.argtypes = [vp, ci, ci, ci, ci, ci, vp]
    lib.stage_lap_launch.restype = ci
    lib.clock_stamp_launch.argtypes = [vp, vp]
    lib.clock_stamp_launch.restype = ci
    return lib


MAX_LEVELS = 8   # graph levels whose native nodes the assembly counts


def encode(code, pieces, flags) -> list:
    """`code` (a `Program`'s order) as the assembly's int32 program: a
    piece is (0, its index in `pieces`), a while loop (1, its flag's index
    in `flags`, the length of its body's encoding) and then its body."""
    out = []
    for item in code:
        if isinstance(item, str):
            out += [0, pieces.index(item)]
        else:
            flag, body = item
            inner = encode(body, pieces, flags)
            out += [1, flags.index(flag), len(inner)] + inner
    return out


class _ProgramExec:
    """The instantiated parent graph of a device program (a
    cudaGraphExec_t made by csrc/graph_while.cu), destroyed with this
    object: each piece a child graph node, each while loop a conditional
    while node with a one-thread `set_cond` kernel node before it and at
    the end of its body."""

    def __init__(self, label, pieces, flags, program):
        lib = _program_lib()
        raws = []
        for p in pieces:
            try:
                raws.append(p.graph.raw_cuda_graph())
            except (AttributeError, RuntimeError) as exc:
                raise RuntimeError(
                    f"{label}: piece {p.name} has no kept cudaGraph_t "
                    f"(torch.cuda.CUDAGraph(keep_graph=True) and "
                    f"raw_cuda_graph() are needed): {exc}") from exc
        vp = ctypes.c_void_p
        handle = vp(0)
        levels = (ctypes.c_int * MAX_LEVELS)()
        msg = ctypes.create_string_buffer(512)
        err = lib.graph_program_build(
            (vp * len(raws))(*raws), len(raws),
            (vp * len(flags))(*(f.data_ptr() for f in flags)), len(flags),
            (ctypes.c_int * len(program))(*program), len(program),
            ctypes.byref(handle), levels, MAX_LEVELS, msg, len(msg))
        if err != 0:
            raise RuntimeError(f"{label}: building the device program "
                               f"failed at {msg.value.decode()}")
        self.lib, self.handle = lib, handle
        n = [int(v) for v in levels]
        while n and n[-1] == 0:
            n.pop()
        self.nodes = tuple(n)   # native nodes per graph level

    def launch(self, label) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        err = self.lib.graph_while_launch(self.handle,
                                          ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(
                f"{label}: cudaGraphLaunch of the device program failed: "
                f"cudaError {err} "
                f"({self.lib.graph_while_error_string(err).decode()})")

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.graph_while_destroy(self.handle)
            self.handle = None


def _build_program(label, device, prog) -> tuple:
    """Warm up `prog`'s pieces, capture each with torch, assemble them in
    `prog.code`'s order. Returns (exec, pieces, capture s, assembly s,
    device bytes the assembly took)."""
    stream = _capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        prog.warm_up()
    stream.synchronize()
    t0 = time.perf_counter()
    pieces = []
    prog.adopt = True
    try:
        for name in prog.PIECES:
            graph, rec, secs, nodes = _capture(
                f"{label} piece {name}", device,
                functools.partial(prog.run, name))
            pieces.append(_Piece(name, graph, rec, secs, nodes))
    finally:
        prog.adopt = False
    t1 = time.perf_counter()
    free = torch.cuda.mem_get_info(device)[0]
    native = _ProgramExec(label, pieces,
                          [prog.flag[n] for n in prog.FLAGS],
                          encode(prog.code, prog.PIECES, prog.FLAGS))
    taken = free - torch.cuda.mem_get_info(device)[0]
    return native, pieces, t1 - t0, time.perf_counter() - t1, taken


def build_program(label, prog) -> "_Graph":
    """`prog` (a `Program` on CUDA tensors) as a device program outside the
    entry points' cache: run it with `replay_program`; its counts stay in
    `prog.runs` (they are not folded into the counters)."""
    return program_graph(label, prog.runs.device, prog, [], ())


def program_graph(label, device, prog, inputs, keep, **kw) -> _Graph:
    """`prog` built into a device program (`_build_program`) labelled
    `label`: its static inputs `inputs` (the buffers `replay`'s load
    writes), `keep` the objects its key names by identity; `kw` more
    fields of `_Graph` (host_inputs, addresses)."""
    native, pieces, capture_s, assembly_s, taken = _build_program(
        label, device, prog)
    if not _OFFSETS.get(str(torch.device(device))):
        _measure_offset(device)
    known = [p.nodes for p in pieces]
    return _Graph(label=label, graph=native, inputs=inputs, outputs=prog,
                  launches={}, capture_s=capture_s + assembly_s,
                  nodes=None if None in known else sum(known)
                  + sum(native.nodes),
                  keep=keep, pieces=tuple(pieces),
                  native_nodes=native.nodes, assembly_s=assembly_s,
                  assembly_bytes=taken,
                  folded=[0] * len(pieces), **kw)


def replay_program(g: _Graph) -> None:
    """Launch the program on the current stream. Nothing is read on the
    host: its pieces' runs stay in `prog.runs` until `fold_counts`."""
    global REPLAYS
    g.graph.launch(g.label)
    g.replays += 1
    REPLAYS += 1


def replay(key, device, build, load, result):
    """An entry point's replay on `device`, under the lock: the program of
    `key`, on a miss `build()` (a `_Graph`, `program_graph`; its inputs
    loaded) inside span `graphs.build`, else `load(g)` (this call's inputs
    copied into its static buffers) inside `graphs.load`, is launched on
    the current stream inside `graphs.launch`; returns `result(g)` (what
    the caller owns), taken inside `graphs.clone`."""
    with torch.cuda.device(device), _LOCK:
        g = _GRAPHS.get(key)
        if g is None:
            with spans.span("graphs.build"):
                g = _GRAPHS[key] = build()
        else:
            with spans.span("graphs.load", request=g.replays):
                load(g)
        k = g.replays
        with spans.span("graphs.launch", request=k):
            replay_program(g)
        with spans.span("graphs.clone", request=k):
            return result(g)


def fold_counts() -> None:
    """Add the runs of every program's pieces since the last fold, times
    each piece's launches, to the kernels' counters, and keep each
    program's last-run counts for `stats` (one host read per program that
    ran). Called whenever a counter is read or set (`ops/counters.py`)."""
    with _LOCK:
        for g in _GRAPHS.values():
            _fold(g)


def _fold(g) -> None:
    if not g.pieces or g.replays == g.folded_replays:
        return
    meter = g.outputs.meter.cpu().numpy()
    n = len(g.pieces)
    total, last = meter[:2 * n].reshape(2, n).tolist()
    g.clock = meter[2 * n:].reshape(1 + RING_ROWS, 2 + len(STAGES))
    counts = _counts()
    for p, now, before in zip(g.pieces, total, g.folded):
        for c, v in p.launches.items():
            counts[c] += (now - before) * v
    _set_counts(counts)
    g.folded, g.last_runs, g.folded_replays = total, last, g.replays
    g.launches = {c: sum(n * p.launches.get(c, 0)
                         for n, p in zip(last, g.pieces))
                  for c in counts}


def rebuild(tree, tensors):
    """tree with its tensor leaves replaced, in order, by `tensors`."""
    it = iter(tensors)

    def sub(obj):
        if isinstance(obj, torch.Tensor):
            return next(it)
        if dataclasses.is_dataclass(obj):
            return type(obj)(**{f.name: sub(getattr(obj, f.name))
                                for f in dataclasses.fields(obj)})
        if isinstance(obj, dict):
            return {k: sub(v) for k, v in obj.items()}
        if isinstance(obj, (tuple, list)):
            return type(obj)(sub(v) for v in obj)
        return obj

    return sub(tree)


def stats() -> list:
    """One record per graph (after `fold_counts`): label, replays, capture
    seconds (warm-up excluded; the assembly included, also apart as
    `assembly_s`, with the device bytes it took, `assembly_bytes`), nodes
    (captured: the pieces' and the native ones; None where not known), and
    of its last replay: the kernel launches by counter
    ('riccati_hkd.LAUNCHES', ...), `iterations` (outer, inner), `retries`
    (retry sweeps) and `nodes_run` (each piece's nodes times its runs).
    `pieces` has each captured piece's nodes, capture seconds, launches per
    run and runs in the last replay; `native_nodes` the nodes of the
    parent graph and of the while bodies at each depth (child graphs,
    set_cond kernels, while nodes). From the stage clock: `stage_ms`, the
    median over the replays its ring holds of each stage's ms (`STAGES`),
    `device_ms`, the median of the replays' device ms (their first stamp
    to their last), `laps`, the laps run per stage since the first
    replay, and the clock offset of the program's device as measured now
    (`clock_offset`: device ns less host ns, and its uncertainty)."""
    name = lambda m, n: f"{m.__name__.rsplit('.', 1)[-1]}.{n}"
    per = lambda launches: {name(*c): dict(launches).get(c, 0)
                            for c in counters.REGISTRY}
    fold_counts()
    offsets = _refresh_offsets()
    out = []
    for g in list(_GRAPHS.values()):
        runs = dict(zip((p.name for p in g.pieces), g.last_runs))
        prog = g.outputs
        known = all(p.nodes is not None for p in g.pieces)
        stage_ms, device_ms = ((None, None) if g.clock is None
                               else stage_summary(g.clock))
        out.append(dict(
            label=g.label, replays=g.replays, capture_s=g.capture_s,
            nodes=g.nodes, launches=per(g.launches),
            iterations=(tuple(runs.get(p, 0) for p in prog.ITERATION_PIECES)
                        if g.replays else None),
            retries=runs.get(prog.RETRY_PIECE, 0) if g.replays else None,
            nodes_run=(sum(p.nodes * runs.get(p.name, 0) for p in g.pieces)
                       if known and g.replays else None),
            native_nodes=g.native_nodes, assembly_s=g.assembly_s,
            assembly_bytes=g.assembly_bytes,
            pieces={p.name: dict(nodes=p.nodes, capture_s=p.capture_s,
                                 launches=per(p.launches),
                                 runs=runs.get(p.name, 0))
                    for p in g.pieces},
            stage_ms=stage_ms, device_ms=device_ms,
            laps=(None if g.clock is None
                  else dict(zip(STAGES, g.clock[0, 2:].tolist()))),
            clock_offset=offsets.get(_device_of(g))))
    return out


def _device_of(g) -> str:
    return str(g.outputs.meter.device)


def clock_offset(device) -> tuple:
    """(host ns, offset ns, uncertainty ns) of `device`'s %globaltimer
    against the host's `time.time_ns()`: a one-thread stamp kernel
    launched on an idle device between two host reads, the second after a
    synchronize; the offset is the stamp less the reads' midpoint, the
    uncertainty half their distance, the best of `OFFSET_TRIES`."""
    dev = torch.device(device)
    lib = _clock_lib()
    out = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev)
    best = None
    for _ in range(OFFSET_TRIES):
        torch.cuda.synchronize(dev)
        t0 = time.time_ns()
        err = lib.clock_stamp_launch(ctypes.c_void_p(out.data_ptr()),
                                     ctypes.c_void_p(stream.cuda_stream))
        stream.synchronize()
        t1 = time.time_ns()
        if err != 0:
            raise RuntimeError(f"clock_stamp launch failed: cudaError {err}")
        mid = (t0 + t1) // 2
        got = (mid, int(out.item()) - mid, (t1 - t0) // 2)
        if best is None or got[2] < best[2]:
            best = got
    return best


def _measure_offset(device) -> tuple:
    got = clock_offset(device)
    _OFFSETS.setdefault(str(torch.device(device)),
                        collections.deque(maxlen=256)).append(got)
    return got


def _refresh_offsets() -> dict:
    """Measure the offset again on every device that has a program; returns
    {device: {"ns": offset, "uncertainty_ns": ...}} of the new readings."""
    out = {}
    for dev in sorted({_device_of(g) for g in _GRAPHS.values()}):
        _, off, unc = _measure_offset(dev)
        out[dev] = dict(ns=off, uncertainty_ns=unc)
    return out


def _to_host(device, stamps) -> tuple:
    """Device stamps (ns) of `device` on the host clock: the offset
    interpolated between the readings around each stamp (held beyond
    them); returns (host ns array, uncertainty ns array)."""
    got = sorted(_OFFSETS.get(str(device), []))
    stamps = np.asarray(stamps, dtype=np.int64)
    if not got:
        nan = np.full(stamps.shape, np.nan)
        return nan, nan
    at = np.array([h + o for h, o, _ in got], dtype=np.float64)
    off = np.interp(stamps.astype(np.float64), at,
                    np.array([o for _, o, _ in got], dtype=np.float64))
    unc = np.interp(stamps.astype(np.float64), at,
                    np.array([u for _, _, u in got], dtype=np.float64))
    return stamps - np.round(off).astype(np.int64), unc


def replay_records(label=None) -> list:
    """The replays each program's stage clock still holds (the last
    `RING_ROWS`), of the programs labelled `label` (all where None), oldest
    first by program: label, program (an id), device, replay (its index in
    the program), stamps (its first and last stamp, device ns), start_ns /
    end_ns (those on the host clock), uncertainty_ns (of that conversion),
    device_ms and stage_ms."""
    fold_counts()
    _refresh_offsets()
    out = []
    for g in list(_GRAPHS.values()):
        if g.clock is None or (label is not None and g.label != label):
            continue
        rows = ring(g.clock)
        if not rows:
            continue
        dev = _device_of(g)
        arr = np.array([r for _, r in rows], dtype=np.int64)
        start, unc = _to_host(dev, arr[:, 0])
        end, _ = _to_host(dev, arr[:, 1])
        for i, (k, r) in enumerate(rows):
            out.append(dict(
                label=g.label, program=id(g), device=dev, replay=k,
                start_ns=int(start[i]), end_ns=int(end[i]),
                stamps=(int(r[0]), int(r[1])), uncertainty_ns=float(unc[i]),
                device_ms=(int(r[1]) - int(r[0])) / 1e6,
                stage_ms=dict(zip(STAGES, (r[2:] / 1e6).tolist()))))
    return out


def span_table(recs) -> tuple:
    """(starts, ends, names) arrays of span records (`utils.spans.Record`),
    as `label_gap` reads them."""
    return (np.array([r.start_ns for r in recs], dtype=np.int64),
            np.array([r.end_ns for r in recs], dtype=np.int64),
            [r.name for r in recs])


def label_gap(a, b, table) -> dict:
    """{name: ns} over the host-clock interval [a, b): at each instant the
    innermost of the spans of `table` (`span_table`) open then (the latest
    begun), "caller" where none is."""
    starts, ends, names = table
    hit = np.flatnonzero((starts < b) & (ends > a))
    cuts = sorted({a, b} | {int(v) for v in starts[hit] if a < v < b}
                  | {int(v) for v in ends[hit] if a < v < b})
    out: dict = {}
    for lo, hi in zip(cuts, cuts[1:]):
        inside = [i for i in hit if starts[i] <= lo and ends[i] >= hi]
        name = (names[max(inside, key=lambda i: (starts[i], -ends[i]))]
                if inside else "caller")
        out[name] = out.get(name, 0) + hi - lo
    return out


def outside_program() -> list:
    """The device time outside the programs: for each pair of consecutive
    replays on a device (whichever program each is; from the first time
    that every program's clock still holds), the device time from one's
    last stamp to the next's first, oldest first: device, before / after
    (their labels), start_ns / end_ns (on the host clock), ms, and
    by_span: that time in ms split by the innermost host span open at each
    instant (`label_gap`), or {"unaligned": ms} where the clock offset's
    uncertainty exceeds ALIGN_NS. Replays that overlap (two streams) read
    0."""
    recs = replay_records()
    table = span_table(spans.records())
    out = []
    for dev in sorted({r["device"] for r in recs}):
        held: dict = {}
        for r in recs:
            if r["device"] == dev:
                held.setdefault(r["program"], []).append(r)
        wrapped = [rows[0]["start_ns"] for rows in held.values()
                   if rows[0]["replay"] > 0]
        since = max(wrapped, default=None)
        mine = sorted((r for rows in held.values() for r in rows
                       if since is None or r["start_ns"] >= since),
                      key=lambda r: r["start_ns"])
        for a, b in zip(mine, mine[1:]):
            ns = max(0, b["stamps"][0] - a["stamps"][1])
            lo = a["end_ns"]
            if max(a["uncertainty_ns"], b["uncertainty_ns"]) > ALIGN_NS:
                split = {"unaligned": ns / 1e6}
            else:
                split = {k: v / 1e6
                         for k, v in label_gap(lo, lo + ns, table).items()}
            out.append(dict(device=dev, before=a["label"],
                            after=b["label"], start_ns=lo, end_ns=lo + ns,
                            ms=ns / 1e6, by_span=split))
    return out


def forget(tensors) -> int:
    """Drop every graph whose key names the address of one of `tensors`
    (their counts folded first); returns how many. Their memory goes back
    to the allocator, so a graph keyed on tensors that are replaced for
    good does not stay behind."""
    ptrs = {t.data_ptr() for t in tensors}
    with _LOCK:
        fold_counts()
        drop = [k for k, g in _GRAPHS.items() if g.addresses & ptrs]
        for k in drop:
            del _GRAPHS[k]
    return len(drop)


def _signature(tree) -> tuple:
    """The layout of a struct for `rearm`: its structure (dict keys,
    dataclass types) and each leaf's shape, dtype and device."""
    if isinstance(tree, torch.Tensor):
        return (tuple(tree.shape), tree.dtype, tree.device)
    if dataclasses.is_dataclass(tree):
        return (type(tree),) + tuple(
            (f.name, _signature(getattr(tree, f.name)))
            for f in dataclasses.fields(tree))
    if isinstance(tree, dict):
        return tuple((k, _signature(v)) for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return tuple(_signature(v) for v in tree)
    return (tree,)


def rearm(resident, fresh):
    """The MPC steps' resident tables or state after a reset: `fresh`
    copied into `resident`'s tensors where both have one layout (the
    graphs keyed on their addresses replay as before), else `fresh` itself,
    after the graphs keyed on `resident` are dropped (`forget`). Returns
    the struct to keep. The copies go to the current stream, behind any
    step already launched there."""
    if resident is None:
        return fresh
    if _signature(resident) == _signature(fresh):
        for old, new in zip(leaves(resident), leaves(fresh)):
            old.copy_(new)
        return resident
    forget(leaves(resident))
    return fresh


def clear_graphs() -> None:
    """Free every captured graph, its static buffers and the shared memory
    pools; the next call of an entry point captures anew."""
    with _LOCK:
        fold_counts()
        _GRAPHS.clear()
        _POOLS.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


counters.fold_with(fold_counts)

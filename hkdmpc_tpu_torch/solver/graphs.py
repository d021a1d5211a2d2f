"""CUDA graphs of the solve and of the MPC steps: the port's counterpart of
the JAX package's jit cache (`ddp.solve_jit` / `solve_batch`,
`fused.fused_step` / `fleet_step` with the state donated).

JAX compiles each entry point once per static key and runs it as one
device program. Here each entry point is captured once per key into a CUDA
graph (`torch.cuda.CUDAGraph`) and replayed:

- the key: the entry point, its static flags (the option set, `kernel_jac`,
  `parallel_rollout`, the assoc / scan / jvp flags, the model object), and
  every input's shape, dtype and device; the MPC steps also key on the
  addresses of the tables and of the resident state they read and write;
- the capture: a warm-up run of the eager body on a side stream (it builds
  and loads the kernels, makes every cached constant and the cuBLAS
  handles), then the capture of the same body on that stream in
  "thread_local" mode, so that a capture in the MPC service's worker thread
  leaves the polling thread free. Graphs that never run at once share one
  memory pool per device: every replay goes to its caller's current stream
  (the default stream in this package), where they run one after the
  other;
- a replay: the inputs are copied into the graph's static buffers (host
  arrays through pinned staging buffers, copied without blocking), then
  `replay()`; the kernel launches recorded at capture are added to the
  kernels' counters once per replay, so that the counters count what ran.

The loops that stop (`solve_batch` with unroll_caps=False, the JAX
package's `lax.while_loop` solve) are one graph too (`solve_while`): torch
captures each piece of the solve cut at its loops (`WhileSolve` over
`ddp.solve_pieces`), and `csrc/graph_while.cu` puts the pieces under two
nested conditional while nodes; a replay counts each piece's launches
times the iterations it ran.

A capture that fails raises RuntimeError naming the operation that was
not allowed; nothing falls back to eager. `clear_graphs()` frees every
graph, as `jax.clear_caches` frees the compiled programs. A reset of an
MPC object copies its new tables and state into the resident ones
(`rearm`), so the step graphs keyed on their addresses replay on; tensors
replaced for good take their graphs with them (`forget`).

`solve_batch` returns tensors the caller owns (clones of the static
outputs), as a jitted JAX function returns fresh arrays. `fused_step`
keeps the state where the caller keeps it: the captured step ends by
writing the new state over the old, the counterpart of
`donate_argnums=(1,)`, and returns that same state with a bundle the caller
owns.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import threading
import time
import traceback

import numpy as np
import torch

from hkdmpc_tpu_torch.ops import riccati_dense, riccati_hkd

# the kernels' launch counters that a replay adds to
COUNTERS = ((riccati_hkd, "LAUNCHES"), (riccati_hkd, "RETRY_LAUNCHES"),
            (riccati_dense, "LAUNCHES"), (riccati_dense, "RETRY_LAUNCHES"))
REPLAYS = 0          # every replay of every graph

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


def _shape(value) -> tuple:
    """The shape of a host array or of a tensor on any device."""
    if isinstance(value, torch.Tensor):
        return tuple(value.shape)
    return tuple(np.shape(value))


def _layout(tensors) -> tuple:
    return tuple((tuple(t.shape), t.dtype) for t in tensors)


def _counts() -> tuple:
    return tuple(getattr(m, n) for m, n in COUNTERS)


def _set_counts(values) -> None:
    for (m, n), v in zip(COUNTERS, values):
        setattr(m, n, v)


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
    launches: tuple       # per COUNTERS, recorded at capture
    capture_s: float
    nodes: object
    keep: tuple = ()      # objects the key names by identity
    host_inputs: tuple = ()
    replays: int = 0
    addresses: frozenset = frozenset()   # data_ptr()s the key names
    iterations: object = None   # while graphs: (outer, inner) of the last
    pieces: tuple = ()          # while graphs: _Piece per captured piece
    native_nodes: tuple = ()    # while graphs: parent, outer, inner body


class _HostInput:
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


def _capture(label, device, warmup, body) -> tuple:
    """Warm up (unless warmup is None) and capture `body()` on a side
    stream of `device`. Returns (graph, outputs, launches recorded, capture
    seconds, nodes)."""
    stream = _capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    if warmup is not None:
        with torch.cuda.stream(stream):
            warmup()
        stream.synchronize()
    before = _counts()
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:   # a torch that cannot keep the graph: no node count
        graph = torch.cuda.CUDAGraph()
    caller_stream = torch.cuda.current_stream(device)
    t0 = time.perf_counter()
    try:
        with torch.cuda.graph(graph, pool=_pool(device), stream=stream,
                              capture_error_mode="thread_local"):
            out = body()
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
        recorded = tuple(a - b for a, b in zip(_counts(), before))
        _set_counts(before)   # a capture launches nothing
    nodes = _node_count(graph)
    if hasattr(graph, "instantiate"):
        try:
            graph.instantiate()
        except RuntimeError:   # instantiated by capture_end already
            pass
    return graph, out, recorded, time.perf_counter() - t0, nodes


def _replay(g: _Graph) -> None:
    global REPLAYS
    g.graph.replay()
    _set_counts(tuple(a + b for a, b in zip(_counts(), g.launches)))
    g.replays += 1
    REPLAYS += 1


def solve_batch(prob, state, opt, *, kernel_jac, model, parallel_rollout,
                assoc_linear, assoc_backward, scan_backward, aug_sweep,
                jvp_linear):
    """`ddp.solve_batch` on CUDA with unroll_caps=True: replay the solve's
    graph (captured at the first call with this key) on copies of prob and
    state; returns a SolveResult of tensors the caller owns."""
    from hkdmpc_tpu_torch.solver import ddp
    from hkdmpc_tpu_torch.solver.structs import tree_map

    device = prob.xr.device
    flags = dict(kernel_jac=kernel_jac, model=model,
                 parallel_rollout=parallel_rollout,
                 assoc_linear=assoc_linear, assoc_backward=assoc_backward,
                 scan_backward=scan_backward, aug_sweep=aug_sweep,
                 jvp_linear=jvp_linear)
    ins = leaves((prob, state))
    key = _solve_key(opt, device, flags, ins, unroll_caps=True)
    with torch.cuda.device(device):
        with _LOCK:
            g = _GRAPHS.get(key)
            if g is None:
                static = _static_copies(ins, device)
                sp, ss = _rebuild((prob, state), static)
                run = lambda: ddp._solve_batch(sp, ss, opt, capturable=True,
                                               **flags)
                label = (f"solve_batch(B={prob.kind.shape[0]}, "
                         f"T={prob.kind.shape[1]}, kernel_jac={kernel_jac}, "
                         f"parallel_rollout={parallel_rollout}, "
                         f"assoc_backward={assoc_backward})")
                graph, out, rec, secs, nodes = _capture(label, device, run,
                                                        run)
                g = _Graph(label=label, graph=graph, inputs=static,
                           outputs=out, launches=rec, capture_s=secs,
                           nodes=nodes, keep=(model,))
                _GRAPHS[key] = g
            else:
                for s, t in zip(g.inputs, ins):
                    s.copy_(t)
            _replay(g)
            return tree_map(lambda t: t.clone(), g.outputs)


def _write(dst, src) -> None:
    """Copy the struct `src` into the static struct `dst` leaf by leaf. A
    source leaf that shares memory with a destination leaf is cloned first,
    so no copy reads what an earlier copy wrote."""
    dst_leaves = leaves(dst)
    ptrs = {t.data_ptr() for t in dst_leaves}
    srcs = [t.clone() if t.data_ptr() in ptrs else t for t in leaves(src)]
    for d, t in zip(dst_leaves, srcs):
        d.copy_(t)


def _like(tree):
    """Static buffers of tree's layout (`torch.empty_like` per leaf)."""
    return _rebuild(tree, [torch.empty_like(t) for t in leaves(tree)])


class WhileSolve:
    """The loops that stop (`ddp.solve_pieces`, capturable) on static
    buffers: the outer carry `c`, the inner carry `ic`, the two loop
    conditions as device flags and the loop iterations run (`loops`:
    outer, inner). Each piece reads and writes only those and the static
    inputs (prob, state), so a CUDA graph of each piece can run in any
    order a while node gives it:

        carry0; while flag_ou: (head; while flag_in: inner; tail)

    On the CPU the tests drive the pieces in that order, reading the flags
    on the host. The buffers are made here, outside any capture, by one run
    of carry0 and head."""

    PIECES = ("carry0", "head", "inner", "tail")

    def __init__(self, prob, state, opt, flags):
        from hkdmpc_tpu_torch.solver import ddp
        self.p = ddp.solve_pieces(prob, state, opt, capturable=True, **flags)
        dev = prob.xr.device
        c = self.p.carry0()
        self.c = _like(c)
        self.ic = _like(self.p.head(c))
        self.flag_ou = torch.zeros((), dtype=torch.bool, device=dev)
        self.flag_in = torch.zeros((), dtype=torch.bool, device=dev)
        self.loops = torch.zeros(2, dtype=torch.int32, device=dev)

    def carry0(self) -> None:
        _write(self.c, self.p.carry0())
        self.flag_ou.copy_(self.p.outer_cond(self.c))
        self.loops.zero_()

    def head(self) -> None:
        _write(self.ic, self.p.head(self.c))
        self.flag_in.copy_(self.p.inner_cond(self.ic))
        self.loops.narrow(0, 0, 1).add_(1)

    def inner(self) -> None:
        _write(self.ic, self.p.inner(self.ic))
        self.flag_in.copy_(self.p.inner_cond(self.ic))
        self.loops.narrow(0, 1, 1).add_(1)

    def tail(self) -> None:
        _write(self.c, self.p.tail(self.ic, self.c))
        self.flag_ou.copy_(self.p.outer_cond(self.c))

    def warm_up(self) -> None:
        """Each piece once, in order (the kernels, constants and handles a
        capture needs are made in a first run)."""
        for name in self.PIECES:
            getattr(self, name)()

    def result(self):
        """The SolveResult on the static outer carry (views of it)."""
        return self.p.result(self.c)

    def iterations(self) -> tuple:
        """(outer, inner) iterations the last run ran (a host read)."""
        return tuple(int(v) for v in self.loops.tolist())


@dataclasses.dataclass
class _Piece:
    name: str
    graph: object         # torch.cuda.CUDAGraph, kept: its pool memory
    launches: tuple       # per COUNTERS, recorded at capture
    capture_s: float
    nodes: object


@functools.cache
def _while_lib():
    """The native assembly of the while graphs (csrc/graph_while.cu),
    built and loaded at first use."""
    from hkdmpc_tpu_torch.ops import _build
    lib = _build.load("graph_while")
    vp, ci = ctypes.c_void_p, ctypes.c_int
    lib.graph_while_build.argtypes = [vp] * 6 + [
        ctypes.POINTER(vp), ctypes.POINTER(ci), ctypes.c_char_p, ci]
    lib.graph_while_build.restype = ci
    lib.graph_while_launch.argtypes = [vp, vp]
    lib.graph_while_launch.restype = ci
    lib.graph_while_destroy.argtypes = [vp]
    lib.graph_while_destroy.restype = ci
    lib.graph_while_error_string.argtypes = [ci]
    lib.graph_while_error_string.restype = ctypes.c_char_p
    return lib


class _WhileExec:
    """The instantiated parent graph of a while solve (a cudaGraphExec_t
    made by csrc/graph_while.cu), destroyed with this object."""

    def __init__(self, label, pieces, flag_ou, flag_in):
        lib = _while_lib()
        raws = []
        for p in pieces:
            try:
                raws.append(p.graph.raw_cuda_graph())
            except (AttributeError, RuntimeError) as exc:
                raise RuntimeError(
                    f"{label}: piece {p.name} has no kept cudaGraph_t "
                    f"(torch.cuda.CUDAGraph(keep_graph=True) and "
                    f"raw_cuda_graph() are needed): {exc}") from exc
        handle = ctypes.c_void_p(0)
        nodes = (ctypes.c_int * 3)()
        msg = ctypes.create_string_buffer(512)
        err = lib.graph_while_build(
            *(ctypes.c_void_p(r) for r in raws),
            ctypes.c_void_p(flag_ou.data_ptr()),
            ctypes.c_void_p(flag_in.data_ptr()), ctypes.byref(handle),
            nodes, msg, len(msg))
        if err != 0:
            raise RuntimeError(f"{label}: building the while graph failed "
                               f"at {msg.value.decode()}")
        self.lib, self.handle = lib, handle
        self.nodes = tuple(nodes)   # parent, outer body, inner body

    def launch(self, label) -> None:
        stream = torch.cuda.current_stream().cuda_stream
        err = self.lib.graph_while_launch(self.handle,
                                          ctypes.c_void_p(stream))
        if err != 0:
            raise RuntimeError(
                f"{label}: cudaGraphLaunch of the while graph failed: "
                f"cudaError {err} "
                f"({self.lib.graph_while_error_string(err).decode()})")

    def __del__(self):
        if getattr(self, "handle", None):
            self.lib.graph_while_destroy(self.handle)
            self.handle = None


def solve_while(prob, state, opt, *, kernel_jac, model, parallel_rollout,
                assoc_linear, assoc_backward, scan_backward, aug_sweep,
                jvp_linear):
    """`ddp.solve_batch` on CUDA with unroll_caps=False: the loops that
    stop as one graph with two nested conditional while nodes, for this key
    (the unroll_caps graph's key with unroll_caps=False), built at the
    first call: a warm-up run of each piece (`WhileSolve.warm_up`), one
    torch capture per piece, and the parent graph assembled and
    instantiated by csrc/graph_while.cu, each piece a child graph node and
    each condition set from its device flag by a one-thread kernel node.
    A replay launches the parent on the current stream, then reads the
    iterations it ran (one host read, after the graph) and adds the pieces'
    launches times their runs to the kernels' counters. Returns a
    SolveResult of tensors the caller owns."""
    from hkdmpc_tpu_torch.solver.structs import tree_map

    device = prob.xr.device
    flags = dict(kernel_jac=kernel_jac, model=model,
                 parallel_rollout=parallel_rollout,
                 assoc_linear=assoc_linear, assoc_backward=assoc_backward,
                 scan_backward=scan_backward, aug_sweep=aug_sweep,
                 jvp_linear=jvp_linear)
    ins = leaves((prob, state))
    key = _solve_key(opt, device, flags, ins, unroll_caps=False)
    with torch.cuda.device(device):
        with _LOCK:
            g = _GRAPHS.get(key)
            if g is None:
                label = (f"solve_while(B={prob.kind.shape[0]}, "
                         f"T={prob.kind.shape[1]}, kernel_jac={kernel_jac}, "
                         f"parallel_rollout={parallel_rollout}, "
                         f"assoc_backward={assoc_backward}, caps "
                         f"{opt.max_AL_iter}x{opt.max_DDP_iter})")
                g = _capture_while(label, device, prob, state, opt, flags,
                                   ins)
                _GRAPHS[key] = g
            else:
                for s, t in zip(g.inputs, ins):
                    s.copy_(t)
            _replay_while(g)
            return tree_map(lambda t: t.clone(), g.outputs.result())


def _capture_while(label, device, prob, state, opt, flags, ins) -> _Graph:
    static = _static_copies(ins, device)
    sp, ss = _rebuild((prob, state), static)
    ws = WhileSolve(sp, ss, opt, flags)
    stream = _capture_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        ws.warm_up()
    stream.synchronize()
    t0 = time.perf_counter()
    pieces = []
    for name in WhileSolve.PIECES:
        graph, _, rec, secs, nodes = _capture(f"{label} piece {name}",
                                              device, None,
                                              getattr(ws, name))
        pieces.append(_Piece(name, graph, rec, secs, nodes))
    native = _WhileExec(label, pieces, ws.flag_ou, ws.flag_in)
    known = [p.nodes for p in pieces]
    nodes = (None if None in known
             else sum(known) + sum(native.nodes))
    return _Graph(label=label, graph=native, inputs=static, outputs=ws,
                  launches=tuple(0 for _ in COUNTERS),
                  capture_s=time.perf_counter() - t0, nodes=nodes,
                  keep=(flags["model"],), pieces=tuple(pieces),
                  native_nodes=native.nodes)


def _replay_while(g: _Graph) -> None:
    global REPLAYS
    g.graph.launch(g.label)
    n_outer, n_inner = g.outputs.iterations()
    runs = dict(carry0=1, head=n_outer, inner=n_inner, tail=n_outer)
    launches = [0] * len(COUNTERS)
    for p in g.pieces:
        for i, v in enumerate(p.launches):
            launches[i] += runs[p.name] * v
    _set_counts(tuple(a + b for a, b in zip(_counts(), launches)))
    g.launches, g.iterations = tuple(launches), (n_outer, n_inner)
    g.replays += 1
    REPLAYS += 1


def _solve_key(opt, device, flags, ins, unroll_caps) -> tuple:
    """A solve graph's key: the option set, the device, the model object,
    the other flags, unroll_caps and the inputs' layout."""
    model = flags["model"]
    return ("solve_batch", opt, device, None if model is None else id(model),
            tuple(sorted((k, v) for k, v in flags.items() if k != "model")),
            bool(unroll_caps), _layout(ins))


def _static_copies(ins, device) -> list:
    """Static input buffers holding copies of `ins`."""
    static = [torch.empty(t.shape, dtype=t.dtype, device=device) for t in ins]
    for s, t in zip(static, ins):
        s.copy_(t)
    return static


def _rebuild(tree, tensors):
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


def fused_step(tables, state, ints, floats, meas, *, opt, parallel_rollout,
               n_cmd, kernel_jac, assoc_linear, assoc_backward):
    """`fused.fleet_step` on CUDA: replay the step's graph for this key.
    `tables` and `state` stay where they are (the graph reads them and
    writes the new state over `state`); ints, floats and meas (host arrays
    or tensors) are copied into the graph's static buffers. Returns
    (state, bundle (N, L) the caller owns)."""
    from hkdmpc_tpu_torch.mpc import fused

    device = state.Xbar.device
    parallel_rollout = bool(parallel_rollout) and bool(opt.MS)
    resident = leaves((tables, state))
    host_shapes = ((_shape(ints), torch.int32),
                   (_shape(floats), state.Xbar.dtype),
                   (_shape(meas), state.Xbar.dtype))
    addresses = tuple(t.data_ptr() for t in resident)
    key = ("fused_step", opt, device, parallel_rollout, int(n_cmd),
           bool(kernel_jac), bool(assoc_linear), bool(assoc_backward),
           _layout(resident), addresses, host_shapes)
    with torch.cuda.device(device):
        with _LOCK:
            g = _GRAPHS.get(key)
            new = g is None
            if new:
                host = tuple(_HostInput(shape, dtype, device)
                             for shape, dtype in host_shapes)
            else:
                host = g.host_inputs
            for h, v in zip(host, (ints, floats, meas)):
                h.load(v)
            if new:
                def step():
                    return fused._fused_core(
                        tables, state, *(h.device_buf for h in host), opt,
                        parallel_rollout, n_cmd, kernel_jac, assoc_linear,
                        assoc_backward, capturable=True)

                def step_in_place():
                    new_state, bundle = step()
                    for old, fresh in zip(leaves(state), leaves(new_state)):
                        old.copy_(fresh)
                    return bundle

                n = state.Xbar.shape[0]
                label = (f"fleet_step(N={n}, T={state.Ubar.shape[1]}, "
                         f"kernel_jac={kernel_jac}, parallel_rollout="
                         f"{parallel_rollout}, assoc_backward="
                         f"{assoc_backward})")
                graph, out, rec, secs, nodes = _capture(label, device, step,
                                                        step_in_place)
                g = _Graph(label=label, graph=graph, inputs=[],
                           outputs=out, launches=rec, capture_s=secs,
                           nodes=nodes, host_inputs=host,
                           addresses=frozenset(addresses))
                _GRAPHS[key] = g
            _replay(g)
            return state, g.outputs.clone()


def stats() -> list:
    """One record per graph: label, replays, capture seconds (warm-up
    excluded), nodes (None where not known) and the kernel launches per
    replay by counter ('riccati_hkd.LAUNCHES', ...). A while graph's
    launches are its last replay's, `iterations` the (outer, inner) loop
    iterations that replay ran (None for the other graphs), `pieces` each
    captured piece's nodes, capture seconds and launches per run, and
    `native_nodes` the nodes of its parent graph and of the outer and inner
    while bodies (child graphs, set_cond kernels, while nodes)."""
    name = lambda m, n: f"{m.__name__.rsplit('.', 1)[-1]}.{n}"
    per = lambda launches: {name(m, n): v
                            for (m, n), v in zip(COUNTERS, launches)}
    return [dict(label=g.label, replays=g.replays, capture_s=g.capture_s,
                 nodes=g.nodes, launches=per(g.launches),
                 iterations=g.iterations, native_nodes=g.native_nodes,
                 pieces={p.name: dict(nodes=p.nodes, capture_s=p.capture_s,
                                      launches=per(p.launches))
                         for p in g.pieces})
            for g in _GRAPHS.values()]


def forget(tensors) -> int:
    """Drop every graph whose key names the address of one of `tensors`;
    returns how many. Their memory goes back to the allocator, so a graph
    keyed on tensors that are replaced for good does not stay behind."""
    ptrs = {t.data_ptr() for t in tensors}
    with _LOCK:
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
        _GRAPHS.clear()
        _POOLS.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

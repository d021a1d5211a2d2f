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

A capture that fails raises RuntimeError naming the operation that was
not allowed; nothing falls back to eager. `clear_graphs()` frees every
graph, as `jax.clear_caches` frees the compiled programs.

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


def _capture(label, device, warmup, body) -> tuple:
    """Warm up and capture `body()` on a side stream of `device`. Returns
    (graph, outputs, launches recorded, capture seconds, nodes)."""
    stream = torch.cuda.Stream(device=device)
    stream.wait_stream(torch.cuda.current_stream(device))
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
    key = ("solve_batch", opt, device, None if model is None else id(model),
           tuple(sorted((k, v) for k, v in flags.items() if k != "model")),
           _layout(ins))
    with torch.cuda.device(device):
        with _LOCK:
            g = _GRAPHS.get(key)
            if g is None:
                static = [torch.empty(t.shape, dtype=t.dtype, device=device)
                          for t in ins]
                for s, t in zip(static, ins):
                    s.copy_(t)
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
    key = ("fused_step", opt, device, parallel_rollout, int(n_cmd),
           bool(kernel_jac), bool(assoc_linear), bool(assoc_backward),
           _layout(resident), tuple(t.data_ptr() for t in resident),
           host_shapes)
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
                           nodes=nodes, host_inputs=host)
                _GRAPHS[key] = g
            _replay(g)
            return state, g.outputs.clone()


def stats() -> list:
    """One record per graph: label, replays, capture seconds (warm-up
    excluded), nodes (None where not known) and the kernel launches per
    replay by counter ('riccati_hkd.LAUNCHES', ...)."""
    return [dict(label=g.label, replays=g.replays, capture_s=g.capture_s,
                 nodes=g.nodes,
                 launches={f"{m.__name__.rsplit('.', 1)[-1]}.{n}": v
                           for (m, n), v in zip(COUNTERS, g.launches)})
            for g in _GRAPHS.values()]


def clear_graphs() -> None:
    """Free every captured graph, its static buffers and the shared memory
    pools; the next call of an entry point captures anew."""
    with _LOCK:
        _GRAPHS.clear()
        _POOLS.clear()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()

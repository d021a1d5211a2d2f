"""Scenario batching and scale-out — port of `hkdmpc_tpu/parallel/batch.py`.

- `replicate_problem` / `perturb_scenarios`: one problem tiled along a
  leading scenario axis, initial states perturbed (the BASELINE config-5
  workload: perturbed-initial-state scenarios of one gait).
- Scale-out on `torch.distributed`, one process per device: the torch idiom
  for the JAX package's scenario mesh. `init_multihost` joins the process
  group (NCCL for a CUDA device, gloo for the CPU), `make_mesh` describes
  this process's place in it, and `solve_sharded` solves the process's
  contiguous block of scenarios (the JAX `P(axis)` layout) with
  `ddp.solve_batch`. Per-scenario solves are independent, so the only
  collectives are the metric reductions: one SUM and one MAX all-reduce of
  small tensors on the group's device.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from hkdmpc_tpu_torch.solver.structs import ProblemData, SolverState, tree_map


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in the scenario mesh: the process group, its
    rank and world size, the device its collectives run on (a CUDA device
    for NCCL, the CPU for gloo) and the axis name."""
    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "scenario"


def make_mesh(device=None, axis: str = "scenario") -> Mesh:
    """The Mesh of the initialized default process group. device: the
    device of the collectives (default: the current CUDA device for NCCL,
    the CPU otherwise). Raises RuntimeError when no process group is
    initialized: call `init_multihost` first (there is no single-process
    mesh to fall back on)."""
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh: no torch.distributed process group is "
                           "initialized; call init_multihost() first")
    if device is None:
        device = (torch.device("cuda", torch.cuda.current_device())
                  if dist.get_backend() == "nccl" else torch.device("cpu"))
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(),
                size=dist.get_world_size(), device=torch.device(device),
                axis=axis)


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None, *,
                   device="cuda") -> Mesh:
    """Join the process group of a multi-process run and return its Mesh;
    call it once in every process, before any other collective.

    coordinator: "host:port" of rank 0's store (`tcp://coordinator`), with
    num_processes and process_id; with no arguments the group is read from
    the environment (`env://`: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK, as
    `torchrun` sets them), the analog of JAX's auto-detection. device
    "cuda" (or "cuda:i") takes NCCL, bound to that device (default: index
    LOCAL_RANK, else the process id modulo the visible devices); "cpu"
    takes gloo. A failed initialization raises."""
    dev = torch.device(device)
    if coordinator is not None:
        if num_processes is None or process_id is None:
            raise ValueError("init_multihost: a coordinator needs "
                             "num_processes and process_id")
        init = dict(init_method=f"tcp://{coordinator}",
                    world_size=int(num_processes), rank=int(process_id))
        rank = int(process_id)
    else:
        init = dict(init_method="env://")
        rank = int(os.environ.get("RANK", 0))
    if dev.type == "cuda":
        if dev.index is None:
            local = os.environ.get("LOCAL_RANK")
            dev = torch.device("cuda", int(local) if local is not None
                               else rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
        dist.init_process_group(backend="nccl", device_id=dev, **init)
    elif dev.type == "cpu":
        dist.init_process_group(backend="gloo", **init)
    else:
        raise ValueError(f"init_multihost: no backend for device {dev}")
    return make_mesh(dev)


def host_local_batch(global_batch: int) -> int:
    """This process's share of a global scenario batch (data-parallel
    layout); the world size must divide it."""
    world = dist.get_world_size()
    if global_batch % world:
        raise ValueError(f"a global batch of {global_batch} does not split "
                         f"over {world} processes")
    return global_batch // world


def replicate_problem(prob: ProblemData, state: SolverState, batch: int):
    """Tile a single problem/state along a new leading scenario axis."""
    tile = lambda a: a[None].repeat((batch,) + (1,) * a.dim())
    return tree_map(tile, prob), tree_map(tile, state)


def default_x0_scale(dtype, device):
    """Modest perturbations: orientation/position/velocity/leg states."""
    return torch.tensor([0.03] * 3 + [0.01] * 3 + [0.1] * 3 + [0.05] * 3
                        + [0.01] * 12, dtype=dtype, device=device)


def perturb_scenarios(prob_b: ProblemData, *, generator=None, noise=None,
                      x0_scale=None) -> ProblemData:
    """Perturb the batched initial conditions: x0 + noise * x0_scale.

    noise: standard-normal draws (B, 24) as a numpy array or tensor; or
    generator: a torch.Generator on the problem's device to draw them from.
    Exactly one of the two is given."""
    if (noise is None) == (generator is None):
        raise ValueError("give exactly one of noise= and generator=")
    x0 = prob_b.x0
    if noise is None:
        noise = torch.randn(x0.shape, generator=generator, dtype=x0.dtype,
                            device=x0.device)
    else:
        noise = torch.as_tensor(np.asarray(noise) if not isinstance(
            noise, torch.Tensor) else noise, dtype=x0.dtype, device=x0.device)
    if x0_scale is None:
        x0_scale = default_x0_scale(x0.dtype, x0.device)
    return dataclasses.replace(prob_b, x0=x0 + noise * x0_scale)


def local_block(n: int, mesh: Mesh) -> slice:
    """The rows of this process in a global axis of n: the contiguous block
    rank * n / size ... (rank + 1) * n / size. Raises ValueError when the
    world size does not divide n."""
    if n % mesh.size:
        raise ValueError(f"{n} scenarios do not split over a mesh of "
                         f"{mesh.size} processes")
    m = n // mesh.size
    return slice(mesh.rank * m, (mesh.rank + 1) * m)


def solve_sharded(prob_b: ProblemData, state_b: SolverState, opt, mesh: Mesh,
                  axis: str = "scenario", *, kernel_jac: bool,
                  local: bool = False, **solve_batch_keywords):
    """Batched solve over the mesh: this process solves its contiguous block
    of scenarios with `ddp.solve_batch(kernel_jac=, **solve_batch_keywords)`
    (the JAX `P(axis)` layout) and the solve metrics are reduced over the
    group.

    prob_b / state_b: by default the global batch, the same in every
    process; this process takes its rows (`local_block`), and the world size
    must divide the batch. With local=True they are already this process's
    block, e.g. built `host_local_batch(global)` scenarios long. `axis`
    names the mesh axis, as in the JAX package (one axis here: it must be
    the mesh's).

    Returns (the local SolveResult, agg): agg holds mean_cost (the
    all-reduced sum over the all-reduced count), max_tconstr and max_feas
    (all-reduced maxima) and n_failed (the all-reduced count), from one SUM
    and one MAX all-reduce on mesh.device, equal in every process."""
    from hkdmpc_tpu_torch.solver import ddp

    if axis != mesh.axis:
        raise ValueError(f"solve_sharded: axis {axis!r}, the mesh's is "
                         f"{mesh.axis!r}")
    if not local:
        rows = local_block(prob_b.kind.shape[0], mesh)
        prob_b = tree_map(lambda a: a[rows], prob_b)
        state_b = tree_map(lambda a: a[rows], state_b)
    res = ddp.solve_batch(prob_b, state_b, opt, kernel_jac=kernel_jac,
                          **solve_batch_keywords)
    return res, solve_metrics(res, mesh)


def solve_metrics(res, mesh: Optional[Mesh] = None) -> dict:
    """The aggregate metrics of a batched SolveResult: mean_cost (the sum
    over the count, in float64), max_tconstr, max_feas and n_failed. With a
    mesh, over the whole group: one SUM and one MAX all-reduce on
    mesh.device; without, over this batch alone."""
    f64 = dict(dtype=torch.float64,
               device=res.cost.device if mesh is None else mesh.device)
    sums = torch.stack([res.cost.to(**f64).sum(),
                        torch.tensor(float(res.cost.shape[0]), **f64),
                        res.solve_failed.to(**f64).sum()])
    maxes = torch.stack([res.max_tconstr.to(**f64).max(),
                         res.dyn_feas.to(**f64).max()])
    if mesh is not None:
        dist.all_reduce(sums, op=dist.ReduceOp.SUM, group=mesh.group)
        dist.all_reduce(maxes, op=dist.ReduceOp.MAX, group=mesh.group)
    sums, maxes = sums.tolist(), maxes.tolist()
    return {"mean_cost": sums[0] / sums[1], "max_tconstr": maxes[0],
            "max_feas": maxes[1], "n_failed": int(round(sums[2]))}

"""The benchmark's inputs, made from `--seed` and handed the same to the
program and to the plain reference: the gait files, the perturbed initial
states of a scenario sweep, the lanes of a mixed-gait batch and a fleet's
measurements.

Frozen copies of the port's generators: `X0_SCALE` is
`parallel.batch.default_x0_scale`, `measurements` draws the noise of
`workload.meas_stream` (a draw per seed and tick) about the plan's body
state at the tick, and `combine` lays out lanes as `bench.interleave`
does. The gait files come from the reference's copy of the
`GaitSynthesizer` (`hkdref.reference.refgen`).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from hkdref.mpc.stand import STAND_QLEG
from hkdref.reference.quad_reference import QuadReference
from hkdref.reference.refgen import GaitSynthesizer

# x0 perturbation scale: orientation, position, angular and linear
# velocity, then the 12 foot / joint coordinates
X0_SCALE = [0.03] * 3 + [0.01] * 3 + [0.1] * 3 + [0.05] * 3 + [0.01] * 12
LEAD_IN_S = 0.2                    # the synthesizer's stand lead-in


def gait_file(directory: str, gait: str, seconds: float, vx: float) -> str:
    """Write the synthesized gait (after a 0.2 s stand lead-in, `seconds`
    of `gait` at `vx` m/s, then the synthesizer's 1 s stand lead-out) in
    the reference CSV format; returns the path."""
    path = os.path.join(directory, f"{gait}_{seconds:g}s.csv")
    if not os.path.exists(path):
        GaitSynthesizer().write(path, ((gait, float(seconds), float(vx)),),
                                lead_in=LEAD_IN_S)
    return path


def gait_ticks(seconds: float, plan_s: float, dt: float) -> int:
    """The receding-horizon ticks (tick k plans from k dt) whose whole plan
    lies before the end of the gait's `seconds`: past them the plan reaches
    the stand lead-out, and the mix of the ticks changes."""
    return int(np.floor((LEAD_IN_S + seconds - plan_s) / dt + 1e-9)) + 1


def plan_body(path: str) -> np.ndarray:
    """(rows, 12) body states of a gait file, one row a dt: euler (yaw,
    pitch, roll), position, angular velocity (body), velocity (world)."""
    return np.asarray(QuadReference.from_file(path).body_state, np.float64)


def lane_gaits(gaits, batch: int, layout: str) -> list:
    """The gait of each lane: one gait for every lane (`uniform`), or two
    with lanes alternating (`interleaved`)."""
    if layout == "uniform" and len(gaits) == 1:
        return [gaits[0]] * batch
    if layout == "interleaved" and len(gaits) == 2 and batch % 2 == 0:
        return [gaits[i % 2] for i in range(batch)]
    raise ValueError(f"layout {layout!r} of gaits {gaits} at batch {batch}")


def combine(structs):
    """One batched struct from two of one layout, lanes alternating as
    `lane_gaits` lays them out; a single struct is returned as it is.
    Leaves that are not tensors (host-side notes) are kept where the
    structs agree, else None."""
    if len(structs) == 1:
        return structs[0]
    a, b = structs
    if dataclasses.is_dataclass(a):
        return type(a)(**{f.name: combine((getattr(a, f.name),
                                           getattr(b, f.name)))
                          for f in dataclasses.fields(a)})
    if not isinstance(a, torch.Tensor):
        return a if a == b else None
    return torch.stack([a, b], dim=1).reshape((-1,) + tuple(a.shape[1:]))


def x0_pool(stand_rows: np.ndarray, pool: int, seed: int, device,
            dtype=torch.float32) -> torch.Tensor:
    """(pool, B, 24) initial states: each lane's stand state plus standard
    normal draws scaled by X0_SCALE, one (B, 24) draw per call of the
    window, made on `device` by a generator seeded `seed`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    nb = stand_rows.shape[0]
    noise = torch.randn((pool, nb, 24), generator=gen, dtype=dtype,
                        device=device)
    scale = torch.tensor(X0_SCALE, dtype=dtype, device=device)
    base = torch.as_tensor(stand_rows, dtype=dtype, device=device)
    return base + noise * scale


def measurements(n_robots: int, seed: int, tick: int, plan) -> dict:
    """Tick `tick`'s noisy measurements of n_robots robots that follow the
    plan: its body state at the tick (`plan_body`, row `tick`) and the
    stand's joint angles, plus noise drawn as float32 from a generator
    seeded (seed, tick): rpy (roll, pitch, yaw), p, v, omega (N, 3) and
    qJ (N, 12). So every tick's robots lie as near their plan, however
    far into the gait the tick is."""
    rng = np.random.default_rng([int(seed), int(tick)])
    draw = lambda scale, width: (rng.standard_normal(
        (n_robots, width), dtype=np.float32) * np.float32(scale))
    body = np.asarray(plan[int(tick)], np.float32)
    return dict(
        rpy=body[2::-1] + draw(0.01, 3),
        p=body[3:6] + draw(0.005, 3),
        v=body[9:12] + draw(0.02, 3),
        omega=body[6:9] + draw(0.02, 3),
        qJ=np.tile(np.asarray(STAND_QLEG, np.float32), (n_robots, 4))
        + draw(0.01, 12))


def strata(n: int, k: int, rng, allowed=None) -> np.ndarray:
    """k members of range(n), one drawn from each of k equal blocks of it
    (so that every block, such as each half, has compared members), from
    those `allowed` (a predicate on the index, or None) within the block."""
    edges = np.linspace(0, n, k + 1).round().astype(int)
    out = []
    for i in range(k):
        pool = [j for j in range(edges[i], edges[i + 1])
                if allowed is None or allowed(i, j)]
        out.append(int(rng.choice(pool)))
    return np.asarray(out)

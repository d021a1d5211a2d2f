"""The in-repo workloads: GaitSynthesizer gaits (trot, flytrot) from the
stand pose (`mpc.solver.default_stand_state`) with the HSDDPOption and
ConstraintParams defaults, gait files for the fleet, the fleet's seeded
measurement stream, and what the MPC service needs beside a gait: stand-in
LCM type files and request messages.

With the default 0.6 s plan the trot problem has T = 75 transitions (60 DYN,
4 RESET, 11 PAD); the 2.0 s plan has T = 250. At initialization every node
is a shooting node, so the parallel rollout applies. `model=` builds the
problem for another `ModelSpec`, such as
`hkd_model_spec(swing_constraint=True)` (24 path rows, with the
`ConstraintParams()` swing defaults).
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from hkdmpc_tpu_torch.config import HSDDPOption
from hkdmpc_tpu_torch.mpc.solver import STAND_QLEG, default_stand_state
from hkdmpc_tpu_torch.reference.quad_reference import QuadReference
from hkdmpc_tpu_torch.reference.refgen import GaitSynthesizer
from hkdmpc_tpu_torch.solver.problem import HKDProblem

# (gait, duration s, forward speed m/s) after the synthesizer's stand lead-in
TROT_SEGMENTS = (("trot", 2.0, 0.5),)
GAIT_SEGMENTS = {"trot": TROT_SEGMENTS, "flytrot": (("flytrot", 2.0, 0.5),)}


def gait_file(gait: str, directory: str) -> str:
    """Write the in-repo GaitSynthesizer gait `gait` ("trot" or "flytrot",
    0.5 m/s) into `directory` in the reference CSV format, the file a
    FleetMPC takes; returns its path."""
    return GaitSynthesizer().write(os.path.join(directory, f"{gait}.csv"),
                                   GAIT_SEGMENTS[gait])


# Stand-ins for the reference's lcmtypes/*.lcm, one struct per file
_LCM_SCHEMAS = {
    "hkd_data_lcmt": """
        boolean reset_mpc;
        boolean MS;
        double mpctime;
        int32_t contact[4];
        float p[3];
        float vWorld[3];
        float rpy[3];
        float omegaBody[3];
        float qJ[12];
        float foot_placements[12];""",
    "hkd_command_lcmt": """
        int32_t N_mpcsteps;
        double mpc_times[10];
        float hkd_controls[10][24];
        float des_body_state[10][12];
        int32_t contacts[10][4];
        double statusTimes[10][4];
        float foot_placement[12];
        float feedback[10][12][12];
        float solve_time;""",
    "solver_info_lcmt": """
        int32_t n_iter;
        float cost[n_iter];
        float dyn_feas[n_iter];
        float eqn_feas[n_iter];
        float ineq_feas[n_iter];""",
    "solver_intermtraj_lcmt": """
        int32_t tau_sz;
        int32_t x_sz;
        int32_t u_sz;
        float x_tau[tau_sz][x_sz];
        float u_tau[tau_sz][u_sz];""",
    "opt_sol_lcmt": """
        int32_t N;
        float qdummy[N][12];
        int32_t contacts[N][4];""",
    # the replay trajectory `utils.visualize.publish_replay` writes and
    # `scripts.visualize_motion` reads
    "visualize_quadTraj_lcmt": """
        int32_t len;
        float WB_plan_dur;
        float SRB_plan_dur;
        float WB_dt;
        float SRB_dt;
        float pos[len][3];
        float eul[len][3];
        float vWorld[len][3];
        float eulrate[len][3];
        float qJ[len][12];
        float pFoot[len][12];
        float torque[len][12];
        float grf[len][12];
        float feas[len];""",
    # the TOWR trajectory `scripts.record_motion.towr_msg_to_traj` reads
    "mc_towr_data_t": """
        int32_t len;
        int64_t microtime[len];
        double base_pos[len][3];
        double base_vel[len][3];
        double eul[len][3];
        double eulrate[len][3];
        double ee_pos[len][12];
        int16_t contact[len][4];""",
}


def lcmtypes_dir(directory: str) -> str:
    """Write stand-in `.lcm` schemas of the seven message types the port
    reads and writes into `directory` (one file per struct) and return it:
    the directory `MPCService(lcmtypes_dir=)`,
    `utils.visualize.publish_replay`, the scripts' `--lcmtypes` and
    `comm.lcm_types.load_reference_types` take, as `gait_file` writes the
    gait a solver takes. Five are the MPC service's; visualize_quadTraj_lcmt
    is the replay trajectory, mc_towr_data_t the TOWR trajectory the
    recorder reads.

    The member names, array shapes and length members are the ones the code
    uses (`mpc/runtime.py`, `MPCCommand.to_lcm_dict`: 10 command slots, 24
    controls, 12 body states, 12 x 12 gains; `publish_replay`;
    `towr_msg_to_traj`). **Not verified** against the reference's own
    lcmtypes/*.lcm and scripts/PyBullet/lcmtypes/*.lcm, which are not in this
    repository: each member's primitive type (float or double, int32_t or
    int8_t) and the order of the members. Both enter the type hash, so the
    fingerprints of these stand-ins need not be those on the reference's
    wire; a robot-side controller or replayer needs the real files."""
    os.makedirs(directory, exist_ok=True)
    for name, body in _LCM_SCHEMAS.items():
        with open(os.path.join(directory, f"{name}.lcm"), "w") as f:
            f.write(f"struct {name}\n{{{body}\n}}\n")
    return directory


def mpc_data_message(meas: dict, mpc_time: float, *, reset_mpc: bool = False,
                     MS: bool = True) -> dict:
    """One robot's `hkd_data_lcmt` request from a measurement dict
    (rpy, p, v, omega, qJ: one row of `meas_stream(1, seed)`)."""
    return {"reset_mpc": reset_mpc, "MS": MS, "mpctime": mpc_time,
            "contact": [1, 1, 1, 1], "p": meas["p"], "vWorld": meas["v"],
            "rpy": meas["rpy"], "omegaBody": meas["omega"], "qJ": meas["qJ"],
            "foot_placements": np.zeros(12, np.float32)}


def meas_stream(n_robots: int, seed: int):
    """meas_fn(k) for FleetMPC.rollout_steps: the noisy stand-pose
    measurements of n_robots robots, drawn in sequence from one seeded
    generator (one draw per call, whatever k)."""
    rng = np.random.default_rng(seed)

    def meas_fn(k):
        return dict(
            rpy=rng.normal(scale=0.01, size=(n_robots, 3)),
            p=np.array([0.0, 0.0, 0.25]) + rng.normal(scale=0.005,
                                                      size=(n_robots, 3)),
            v=rng.normal(scale=0.02, size=(n_robots, 3)),
            omega=rng.normal(scale=0.02, size=(n_robots, 3)),
            qJ=np.tile(STAND_QLEG, (n_robots, 4))
            + rng.normal(scale=0.01, size=(n_robots, 12)))
    return meas_fn


def gait_reference(gait: str) -> QuadReference:
    """Synthesize the gait ("trot" or "flytrot"), write it in the
    reference's CSV format and load it back, as a user loads a gait file."""
    with tempfile.TemporaryDirectory() as d:
        return QuadReference.from_file(gait_file(gait, d))


def gait_problem(gait: str, plan_duration: float = 0.6, *,
                 dtype: torch.dtype, device, model=None):
    """(HKDProblem, ProblemData, SolverState, HSDDPOption) of the in-repo
    gait ("trot" or "flytrot") from the stand pose, for `model` (None: the
    default HKD model). Both gaits give problems of one shape at a plan
    (0.6 s: T = 75, the trot 60 DYN, 4 RESET, 11 PAD, the flytrot 60 DYN,
    5 RESET, 10 PAD; 2.0 s: T = 250), so their scenarios share a batch."""
    pb = HKDProblem(gait_reference(gait), plan_duration=plan_duration,
                    dtype=dtype, device=device, model=model)
    pb.initialization()
    prob, state = pb.build(default_stand_state(pb.phases[0].contact))
    return pb, prob, state, HSDDPOption()


def trot_problem(plan_duration: float = 0.6, *, dtype: torch.dtype, device,
                 model=None):
    """gait_problem of the trot."""
    return gait_problem("trot", plan_duration, dtype=dtype, device=device,
                        model=model)

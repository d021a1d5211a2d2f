"""hkdmpc_tpu_torch — PyTorch/CUDA port of hkdmpc_tpu, the batched
hybrid-systems DDP (HS-DDP) solver for kino-dynamic quadruped MPC.

The JAX package `hkdmpc_tpu` is the reference; this package mirrors its
sub-package and module names and covers all of it but the TPU-only
machinery (`ROADMAP.md`'s list of what is not to port): the batched solve
`solver.ddp.solve_batch` on its two paths — `kernel_jac=True`, the default
HKD model's throughput path, and `kernel_jac=False`, the dense-LQ path for
any `solver.model_api.ModelSpec` — with each path's Riccati backward sweep
as a hand-written CUDA kernel for Hopper (`csrc/riccati_hkd.cu` wrapped by
`ops/riccati_hkd.py`, `csrc/riccati_dense.cu` wrapped by
`ops/riccati_dense.py`); the fleet MPC built on it (`mpc.fleet.FleetMPC`:
receding-horizon updates, the batched fleet step `mpc.fused.fleet_step`,
checkpoints in `utils.checkpoint`); one robot's MPC
(`mpc.solver.HKDMPCSolver`); the robot-facing service
(`mpc.runtime.MPCService` over `comm.LCMTransport`, message types parsed at
run time by `comm.lcm_types`); scale-out over processes on
`torch.distributed` (`parallel.batch.init_multihost`, `solve_sharded`,
`FleetMPC(mesh=)`); the utilities (`utils.logging`, `utils.timing`,
`utils.visualize`); and the runnable examples and scripts
(`python -m hkdmpc_tpu_torch.examples.closed_loop_demo`, `.fleet_demo`,
`hkdmpc_tpu_torch.scripts.record_motion`, `.visualize_motion`). This package
imports neither JAX nor any module of `hkdmpc_tpu`: what it needs from there
(`config`, `reference`, `models`) it keeps as its own copy, pinned equal by
the tests.
"""

__version__ = "0.1.0"

"""hkdref: the benchmark's plain reference of the HS-DDP solve, frozen.

A copy of the PyTorch port's plain eager path as it stood when the
benchmark was written: the HKD model and its cost (`models`, `ops`,
`solver.costs`), the gait synthesizer and reference file reader
(`reference`), the problem builder and its receding-horizon update
(`solver.problem`), the batched DDP solve (`solver.ddp`, its eager body),
K1's plain version (`ops.riccati_hkd`) and the fleet step's device half
as tensor code (`mpc.fused`), on the one path the cells run: the default
HKD model with the port's `kernel_jac=True`. No CUDA kernel,
no device program, and no import of the port, of the JAX package or of
JAX: later changes to the port are held against this copy, which they do
not edit. `ops.precise.products_in_tf32` computes it as the benchmark's
control. Runs on any device, in any float dtype.
"""

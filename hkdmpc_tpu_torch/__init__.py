"""hkdmpc_tpu_torch — PyTorch/CUDA port of hkdmpc_tpu, the batched
hybrid-systems DDP (HS-DDP) solver for kino-dynamic quadruped MPC.

The JAX package `hkdmpc_tpu` is the reference; this package mirrors its
sub-package and module names. Ported so far: the batched solve
`solver.ddp.solve_batch` on its two paths — `kernel_jac=True`, the default
HKD model's throughput path, and `kernel_jac=False`, the dense-LQ path for
any `solver.model_api.ModelSpec` — with each path's Riccati backward sweep
as a hand-written CUDA kernel for Hopper (`csrc/riccati_hkd.cu` wrapped by
`ops/riccati_hkd.py`, `csrc/riccati_dense.cu` wrapped by
`ops/riccati_dense.py`). This package never imports JAX.
"""

__version__ = "0.1.0"

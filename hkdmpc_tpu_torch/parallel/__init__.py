from hkdmpc_tpu_torch.parallel.batch import (make_mesh, perturb_scenarios,
                                             replicate_problem, solve_sharded)

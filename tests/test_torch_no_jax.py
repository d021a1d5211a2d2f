"""The PyTorch port never imports JAX: in a fresh interpreter (the test
process has JAX loaded already), import every module of hkdmpc_tpu_torch,
build the trot problem and run one small batched solve on each path (the
default model's kernel_jac path, the dense path with the swing constraint),
then check that `jax` is not in sys.modules."""
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]

SCRIPT = r"""
import importlib, pkgutil, sys
import numpy as np
import torch
import hkdmpc_tpu_torch
for m in pkgutil.walk_packages(hkdmpc_tpu_torch.__path__, "hkdmpc_tpu_torch."):
    importlib.import_module(m.name)
from hkdmpc_tpu_torch.parallel.batch import perturb_scenarios, replicate_problem
from hkdmpc_tpu_torch.solver import ddp
from hkdmpc_tpu_torch.workload import trot_problem
torch.set_num_threads(2)
_, prob, state, opt = trot_problem(dtype=torch.float64, device="cpu")
prob_b, state_b = replicate_problem(prob, state, 2)
prob_b = perturb_scenarios(prob_b, noise=np.random.default_rng(0).standard_normal((2, 24)))
res = ddp.solve_batch(prob_b, state_b, opt.runtime(), kernel_jac=True)
assert bool(torch.isfinite(res.cost).all())
from hkdmpc_tpu_torch.solver.model_api import hkd_model_spec
spec = hkd_model_spec(swing_constraint=True)
_, prob, state, opt = trot_problem(dtype=torch.float64, device="cpu", model=spec)
prob_b, state_b = replicate_problem(prob, state, 2)
res = ddp.solve_batch(prob_b, state_b, opt.runtime(), kernel_jac=False, model=spec)
assert bool(torch.isfinite(res.cost).all())
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
print("NO_JAX_OK")
"""


def test_port_runs_without_jax():
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "NO_JAX_OK" in out.stdout


def test_port_sources_do_not_import_jax():
    for path in (REPO / "hkdmpc_tpu_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            assert not (words[:1] in (["import"], ["from"]) and len(words) > 1
                        and words[1].split(".")[0] == "jax"), (path, line)

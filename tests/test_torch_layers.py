"""The device-program layer points one way, by a source scan (`ast`): the
engine, `solver/graphs.py`, imports no module of `mpc`, not `solver.ddp`
and no kernel wrapper (`ops.riccati_*`, `ops.*rollout_hkd`), at module
level or inside a function; the programs that use it (`ddp.SolveProgram`,
`fused.StepProgram`) import it. No module under `ops/` imports or looks
up by its dotted name (`sys.modules`, `importlib`) `solver.graphs`,
`solver.ddp` or any module of `mpc`. (The plain versions in `ops/` that
import `solver.structs`, `solver.backward`, `solver.rollout` or
`solver.costs` are another crossing, not scanned here.)"""
import ast
import pathlib
import re

REPO = pathlib.Path(__file__).resolve().parents[1]
PKG = REPO / "hkdmpc_tpu_torch"

ENGINE_REFUSES = re.compile(
    r"hkdmpc_tpu_torch\.(mpc(\.|$)|solver\.ddp$"
    r"|ops\.(riccati_\w+|\w*rollout_hkd)$)")
OPS_REFUSE = re.compile(
    r"hkdmpc_tpu_torch\.(mpc(\.|$)|solver\.(graphs|ddp)$)")


def _docstrings(tree) -> set:
    kinds = (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)
    return {id(node.body[0].value) for node in ast.walk(tree)
            if isinstance(node, kinds) and node.body
            and isinstance(node.body[0], ast.Expr)
            and isinstance(node.body[0].value, ast.Constant)}


def modules_named(source: str, package: str = "hkdmpc_tpu_torch") -> set:
    """Every module that `source` (of a module in `package`) imports,
    anywhere in it (`from a import b` names a and a.b; a relative import
    is resolved against `package`), and every string outside a docstring
    that is a dotted name of this package (a lookup by name)."""
    tree = ast.parse(source)
    docs = _docstrings(tree)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            base = package.split(".")
            base = base[:len(base) - node.level + 1] if node.level else []
            mod = ".".join(base + ([node.module] if node.module else []))
            out.add(mod)
            out |= {f"{mod}.{a.name}" for a in node.names}
        elif (isinstance(node, ast.Constant) and isinstance(node.value, str)
              and id(node) not in docs
              and re.fullmatch(r"hkdmpc_tpu_torch(\.\w+)+", node.value)):
            out.add(node.value)
    return out


def test_scan_sees_imports_and_lookups_anywhere():
    source = '''"""hkdmpc_tpu_torch.solver.ddp in a docstring is no import."""
import sys
from hkdmpc_tpu_torch.ops import counters


def f():
    from hkdmpc_tpu_torch.solver import ddp
    from ..mpc import fused
    return sys.modules.get("hkdmpc_tpu_torch.solver.graphs")
'''
    got = modules_named(source, "hkdmpc_tpu_torch.ops")
    assert {"hkdmpc_tpu_torch.ops.counters", "hkdmpc_tpu_torch.solver.ddp",
            "hkdmpc_tpu_torch.mpc.fused",
            "hkdmpc_tpu_torch.solver.graphs"} <= got
    assert sorted(filter(OPS_REFUSE.match, got)) == [
        "hkdmpc_tpu_torch.mpc", "hkdmpc_tpu_torch.mpc.fused",
        "hkdmpc_tpu_torch.solver.ddp", "hkdmpc_tpu_torch.solver.graphs"]
    for name in ("hkdmpc_tpu_torch.ops.riccati_hkd",
                 "hkdmpc_tpu_torch.ops.riccati_dense",
                 "hkdmpc_tpu_torch.ops.rollout_hkd",
                 "hkdmpc_tpu_torch.ops.linear_rollout_hkd",
                 "hkdmpc_tpu_torch.mpc.fleet"):
        assert ENGINE_REFUSES.match(name), name
    for name in ("hkdmpc_tpu_torch.ops.counters",
                 "hkdmpc_tpu_torch.ops._build",
                 "hkdmpc_tpu_torch.utils.spans",
                 "hkdmpc_tpu_torch.solver.ddp_dense"):
        assert not ENGINE_REFUSES.match(name), name


def test_the_engine_knows_no_caller_and_no_kernel():
    got = modules_named((PKG / "solver" / "graphs.py").read_text(),
                        "hkdmpc_tpu_torch.solver")
    assert not sorted(filter(ENGINE_REFUSES.match, got))
    for caller in ("solver/ddp.py", "mpc/fused.py"):
        assert "hkdmpc_tpu_torch.solver.graphs" in modules_named(
            (PKG / caller).read_text(), "hkdmpc_tpu_torch")


def test_ops_do_not_reach_up_to_the_programs():
    for path in sorted((PKG / "ops").rglob("*.py")):
        got = modules_named(path.read_text(), "hkdmpc_tpu_torch.ops")
        assert not sorted(filter(OPS_REFUSE.match, got)), path

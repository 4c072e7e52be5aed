"""The kernels' host side (``gym_futbol_tpu_torch/ops``) imports one way:
each kernel module (``ops/fused_*.py``) takes shared code from
``_policy``, ``fused_rollout`` and ``_build`` only, and no module
imports another's underscore-prefixed names. Read from the sources with
``ast``; nothing is imported."""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "gym_futbol_tpu_torch"
OPS = PKG / "ops"
OPS_NAME = "gym_futbol_tpu_torch.ops"


def _dotted(path: pathlib.Path) -> str:
    """The module name of a file under the repository root."""
    parts = list(path.relative_to(ROOT).with_suffix("").parts)
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def _imports(path: pathlib.Path):
    """(module, name) for each name of each ``from ... import`` in
    ``path``, relative imports resolved."""
    package = _dotted(path)
    if path.name != "__init__.py":
        package = package.rpartition(".")[0]
    for node in ast.walk(ast.parse(path.read_text())):
        if not isinstance(node, ast.ImportFrom):
            continue
        if node.level:
            base = package.rsplit(".", node.level - 1)[0] if node.level > 1 else package
            module = f"{base}.{node.module}" if node.module else base
        else:
            module = node.module
        for alias in node.names:
            yield module, alias.name


def _file(module: str) -> pathlib.Path | None:
    """The source of a module of this repository, or None."""
    for cand in (ROOT.joinpath(*module.split(".")).with_suffix(".py"),
                 ROOT.joinpath(*module.split("."), "__init__.py")):
        if cand.exists():
            return cand
    return None


def _is_module(module: str, name: str) -> bool:
    return _file(f"{module}.{name}") is not None


def _defined(path: pathlib.Path) -> set[str]:
    """The names a module defines at its top level (not those it imports)."""
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif isinstance(node, ast.Assign):
            out.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            out.add(node.target.id)
    return out


def _kernel_module(module: str) -> bool:
    return module.startswith(f"{OPS_NAME}.fused_")


OPS_FILES = sorted(OPS.glob("*.py"))
OUTSIDE_FILES = sorted(p for p in PKG.rglob("*.py") if OPS not in p.parents) + [
    ROOT / "chip_smoke.py"]


def _kernel_modules_reach_only_k1():
    for path in OPS_FILES:
        if path.name.startswith("fused_"):
            own = _dotted(path)
            for module, name in _imports(path):
                target = f"{module}.{name}" if _is_module(module, name) else module
                if _kernel_module(target) and target not in (
                        own, f"{OPS_NAME}.fused_rollout"):
                    yield f"{path.name} imports {name} from {module}"


def _no_private_names_within_ops():
    for path in OPS_FILES:
        for module, name in _imports(path):
            if name.startswith("_") and name != "annotations" and not _is_module(
                    module, name):
                yield f"{path.name} imports {name} from {module}"


def _no_private_names_from_ops():
    for path in OUTSIDE_FILES:
        for module, name in _imports(path):
            if (module.startswith(OPS_NAME) and name.startswith("_")
                    and not _is_module(module, name)):
                yield f"{path.relative_to(ROOT)} imports {name} from {module}"


def _names_from_their_home():
    for path in OPS_FILES + OUTSIDE_FILES:
        for module, name in _imports(path):
            src = _file(module)
            if (module.startswith(f"{OPS_NAME}.") and src is not None
                    and not _is_module(module, name) and name not in _defined(src)):
                yield f"{path.relative_to(ROOT)} imports {name} from {module}, " \
                      f"which does not define it"


@pytest.mark.parametrize("rule", [
    _kernel_modules_reach_only_k1, _no_private_names_within_ops,
    _no_private_names_from_ops, _names_from_their_home,
], ids=["kernel-modules", "private-within-ops", "private-from-ops", "home"])
def test_ops_imports(rule):
    """No kernel module imports from another but ``fused_rollout``; no
    module under ``ops/`` imports an underscore-prefixed name, nor any
    module outside it such a name from ``ops/`` (``_build`` and
    ``_policy`` themselves may be imported); a name taken from a module
    under ``ops/`` is taken from the module that defines it (so the
    learners take shared helpers from ``_policy``, not through a kernel
    module)."""
    assert list(rule()) == []


def test_the_rules_see_imports():
    """The scan finds what it checks: the kernel modules' imports of the
    shared layer, and the package's imports of ``ops``."""
    found = {(p.name, m, n) for p in OPS_FILES for m, n in _imports(p)}
    assert ("fused_collect.py", f"{OPS_NAME}._policy", "tc_plan") in found
    assert ("fused_bptt.py", OPS_NAME, "_build") in found
    outside = {(m, n) for p in OUTSIDE_FILES for m, n in _imports(p)}
    assert (f"{OPS_NAME}.fused_bptt", "fused_lstm_bptt") in outside

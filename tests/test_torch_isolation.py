"""The port imports neither JAX nor the JAX package: not at run time (a fresh
interpreter imports every module of the port, chip_smoke.py and
kernel_times.py) and not in its
sources (an AST scan of every import statement). Importing it also loads
none of the packages it does not depend on (PIL, msgpack, tqdm); PIL is
imported only inside the raw-VOC functions that decode images."""

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "object_detection_torch2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "object_detection_torch2_tpu")
# packages the port does not depend on
NOT_DEPENDED_ON = ("PIL", "msgpack", "tqdm")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_import_pulls_in_no_jax():
    mods = _port_modules() + ["chip_smoke", "kernel_times"]
    assert "object_detection_torch2_tpu_torch.cli.evaluate" in mods
    # `import torch` itself tries tqdm (torch.hub) and goes on without it, so
    # those count only when the port's imports load them
    code = (
        "import importlib, sys\n"
        "import torch\n"
        "by_torch = set(sys.modules)\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "def hit(m, names):\n"
        "    return any(m == f or m.startswith(f + '.') for f in names)\n"
        f"bad = sorted(m for m in sys.modules if hit(m, {FORBIDDEN!r})\n"
        f"             or (m not in by_torch and hit(m, {NOT_DEPENDED_ON!r})))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_import_no_jax():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            bad = [n for n in names if _forbidden(n)]
            assert not bad, f"{path.relative_to(ROOT)}:{node.lineno} imports {bad}"


def test_pil_only_inside_raw_voc_functions():
    """PIL is imported only inside a function of data/voc.py (the raw-VOC
    decode), never at a module's top level."""
    seen = []
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "kernel_times.py"]:
        tree = ast.parse(path.read_text(), str(path))
        inside = {id(n) for f in ast.walk(tree) if isinstance(f, (ast.FunctionDef, ast.AsyncFunctionDef))
                  for n in ast.walk(f)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            else:
                continue
            if any(n == "PIL" or n.startswith("PIL.") for n in names):
                where = f"{path.relative_to(ROOT)}:{node.lineno}"
                assert path == PORT / "data" / "voc.py" and id(node) in inside, f"{where} imports PIL"
                seen.append(where)
    assert seen, "the raw-VOC decode no longer imports PIL"

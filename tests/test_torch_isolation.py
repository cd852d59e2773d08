"""The port imports neither JAX nor the JAX package, nor the repo's root
`tools` package (the port has its own, object_detection_torch2_tpu_torch/tools/):
not at run time (a fresh interpreter imports every module of the port,
chip_smoke.py and kernel_times.py) and not in its
sources (an AST scan of every import statement). Importing it also loads
none of the packages it does not depend on (PIL, msgpack, tqdm); PIL is
imported only inside the functions that decode images (the raw-VOC dataset)
or draw them (utils/render.py). Every port test module caps torch's
intra-op threads (an AST scan)."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "object_detection_torch2_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "object_detection_torch2_tpu",
             "tools")  # the root tools package (the JAX package's scripts)
# packages the port does not depend on
NOT_DEPENDED_ON = ("PIL", "msgpack", "tqdm")


def _port_modules():
    mods = []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        mods.append(".".join(parts))
    return mods


PORT_TOOLS = ("common", "synth_voc", "torch_to_npz", "export_torch", "overfit_proof", "generalization_proof",
              "pretrained_trunk_proof", "int8_budget", "serve_artifact", "voc_scale_proof")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _forbidden_imports(source: str, filename: str = "<source>") -> list:
    """(line, names) of each absolute import statement of `source` that
    names a FORBIDDEN module."""
    found = []
    for node in ast.walk(ast.parse(source, filename)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        if bad:
            found.append((node.lineno, bad))
    return found


def test_import_pulls_in_no_jax():
    mods = _port_modules() + ["chip_smoke", "kernel_times"]
    for cli in ("evaluate", "train", "inference"):
        assert f"object_detection_torch2_tpu_torch.cli.{cli}" in mods
    for mod in ("parallel", "parallel.mesh"):  # data parallelism on torch.distributed
        assert f"object_detection_torch2_tpu_torch.{mod}" in mods
    for mod in PORT_TOOLS:  # the accuracy proofs and the .pth bridge
        assert f"object_detection_torch2_tpu_torch.tools.{mod}" in mods
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
    assert all(PORT / "tools" / f"{mod}.py" in files for mod in PORT_TOOLS)
    for path in files:
        bad = _forbidden_imports(path.read_text(), str(path))
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("source,flagged", [
    ("import tools.synth_voc", True),
    ("from tools import synth_voc", True),
    ("from tools.export_torch import vgg16_state_dict", True),
    ("import tools", True),
    ("from object_detection_torch2_tpu_torch.tools import synth_voc", False),
    ("from object_detection_torch2_tpu_torch.tools.common import FIXTURE", False),
    ("import toolsmith", False),
    ("from . import common", False),
])
def test_root_tools_import_is_flagged(source, flagged):
    """The scan flags an import of the root `tools` package (the JAX
    package's scripts) in any form, and not the port's own tools."""
    assert bool(_forbidden_imports(source)) is flagged


@pytest.mark.parametrize("cli", ["train", "inference"])
def test_cli_import_loads_no_pil_tqdm_or_msgpack(cli):
    """Importing a CLI alone (as `python -m` does) loads none of PIL, tqdm or
    msgpack: the inference CLI imports PIL only when it runs, the training
    CLI has no progress bar and writes weights with the port's own codec."""
    code = (
        "import importlib, sys\n"
        "import torch\n"
        "by_torch = set(sys.modules)\n"
        f"importlib.import_module('object_detection_torch2_tpu_torch.cli.{cli}')\n"
        "bad = sorted(m for m in set(sys.modules) - by_torch\n"
        f"             if any(m == f or m.startswith(f + '.') for f in {NOT_DEPENDED_ON!r}))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_pil_only_inside_raw_voc_functions():
    """PIL is imported only inside a function of data/voc.py (the raw-VOC
    decode), of utils/render.py (the drawing) or of tools/synth_voc.py (the
    synthetic scenes), never at a module's top level."""
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
                allowed = (PORT / "data" / "voc.py", PORT / "utils" / "render.py", PORT / "tools" / "synth_voc.py")
                assert path in allowed and id(node) in inside, f"{where} imports PIL"
                seen.append(where)
    assert len(seen) == 3, f"PIL is expected in the raw-VOC decode, the drawing and the scenes, found {seen}"


# the card's tests need the whole host (tests/test_torch_cuda.py skips on the CPU)
THREADS_UNCAPPED = {"test_torch_cuda.py"}
TEST_THREADS = 1


def test_every_port_test_module_caps_torch_threads():
    """Each tests/test_torch_*.py module calls
    torch.set_num_threads(TEST_THREADS) at its top level. The tier-1 run puts
    6 xdist workers on 8 cores beside XLA's own thread pools: the machine is
    saturated, and a second intra-op thread adds CPU time (OpenMP spin-waits)
    that it has none to spare for. One value everywhere, because every worker
    imports every module when it collects, and the last import's call holds
    for the whole run; `mesh.launch` gives each CPU rank a share of it (at
    least 1). Parsed, not imported."""
    wrong = []
    modules = sorted(Path(__file__).parent.glob("test_torch_*.py"))
    assert Path(__file__) in modules and len(modules) > 20
    for path in modules:
        if path.name in THREADS_UNCAPPED:
            continue
        caps = [ast.unparse(node.value) for node in ast.parse(path.read_text(), str(path)).body
                if isinstance(node, ast.Expr) and isinstance(node.value, ast.Call)
                and ast.unparse(node.value.func) == "torch.set_num_threads"]
        if caps != [f"torch.set_num_threads({TEST_THREADS})"]:
            wrong.append((path.name, caps))
    assert not wrong, f"each module needs one top-level torch.set_num_threads({TEST_THREADS}): {wrong}"

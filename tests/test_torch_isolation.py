"""The port imports neither JAX nor the JAX package, nor the repo's root
`tools` package (the port has its own, object_detection_torch2_tpu_torch/tools/):
not at run time (a fresh interpreter imports every module of the port,
chip_smoke.py and kernel_times.py) and not in its
sources (an AST scan of every import statement). Importing it also loads
none of the packages it does not depend on (PIL, msgpack, tqdm); PIL is
imported only inside the functions that decode images (the raw-VOC dataset)
or draw them (utils/render.py). Every port test module caps torch's
intra-op threads, and jits no JAX reference as a closure over arrays (AST
scans)."""

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


# A JAX reference is jitted over its arrays as arguments. Closed over, an
# array becomes a constant of the program: XLA folds the convolutions over a
# closed-over trunk at compile time (tens of seconds a program on a cold
# cache) and writes a cache entry that holds the arrays. The scan is
# heuristic: an array is a name the enclosing scope assigned from one of
# these calls (or a list of their results, or the unpacked result of any
# call), or an attribute of `state`.
JITTING = {"jax.jit", "jax.grad", "jax.value_and_grad"}
ARRAY_CALL_PREFIXES = ("jnp.", "np.", "jax.numpy.", "jax.random.")
ARRAY_CALLS = {"jax.device_get", "jax.device_put", "jax.tree.map", "jax.tree_util.tree_map"}
ARRAY_METHODS = {"place_batch"}  # the JAX Trainer's device batch
# (file, the test whose closure it is): why the closed-over value must be a
# constant of the program
_TRAINER_CONTEXT = ("the Trainer's division context: XLA folds the scale, a constant of the JAX Trainer's "
                    "program, into a reciprocal; the test holds the port's reciprocal form to that")
CLOSURE_EXEMPT = {
    ("test_torch_quant.py", "test_quantize_act_matches_each_jax_context"): _TRAINER_CONTEXT,
    ("test_torch_quant.py", "test_one_quantized_layer_matches_jax"): _TRAINER_CONTEXT,
    ("test_torch_int8_prologue.py", "test_quantize_act_op_matches_jax"): _TRAINER_CONTEXT,
}


def _makes_array(value, unpacked: bool = False) -> bool:
    """Whether an assigned value holds arrays: an array-making call, a
    `state.` attribute, a list or tuple of them, or (`unpacked`) any call
    whose result is unpacked into names, as a test's input helpers return."""
    if isinstance(value, ast.Call):
        func = ast.unparse(value.func)
        return (unpacked or func.startswith(ARRAY_CALL_PREFIXES) or func in ARRAY_CALLS
                or isinstance(value.func, ast.Attribute) and value.func.attr in ARRAY_METHODS)
    if isinstance(value, (ast.ListComp, ast.GeneratorExp)):
        return _makes_array(value.elt)
    if isinstance(value, (ast.List, ast.Tuple)):
        return any(_makes_array(e) for e in value.elts)
    return isinstance(value, ast.Attribute) and ast.unparse(value).startswith("state.")


def _bindings(scope) -> dict:
    """{name: whether its binding makes an array} of the names that `scope`
    (a module or function) binds in its own body: assignments, loop targets,
    parameters, definitions and imports."""
    bound = {}
    if isinstance(scope, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
        a = scope.args
        for arg in a.posonlyargs + a.args + a.kwonlyargs + [a.vararg, a.kwarg]:
            if arg is not None:
                bound[arg.arg] = False
    todo = list(scope.body) if isinstance(scope.body, list) else [scope.body]
    while todo:
        node = todo.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            bound[node.name] = False
            continue
        if isinstance(node, ast.Lambda):
            continue
        if isinstance(node, (ast.Assign, ast.AnnAssign, ast.AugAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            unpacked = any(isinstance(t, (ast.Tuple, ast.List)) for t in targets)
            array = node.value is not None and _makes_array(node.value, unpacked)
            for target in targets:
                for name in ast.walk(target):
                    if isinstance(name, ast.Name):
                        bound[name.id] = bound.get(name.id, False) or array
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                bound[(alias.asname or alias.name).split(".")[0]] = False
        elif isinstance(node, ast.Name) and isinstance(node.ctx, ast.Store):
            bound.setdefault(node.id, False)
        todo.extend(ast.iter_child_nodes(node))
    return bound


def _jitted_closures(source: str, filename: str = "<source>") -> list:
    """(line, the enclosing top-level function's name, [free names that hold
    arrays]) of each lambda or function handed to jax.jit / jax.grad /
    jax.value_and_grad that reads an array of an enclosing scope."""
    found = []

    def visit(node, scopes):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            scopes = scopes + [node]
        if isinstance(node, ast.Call) and ast.unparse(node.func) in JITTING and node.args:
            fn, name = node.args[0], None
            if isinstance(fn, ast.Name):  # a function defined in this or an enclosing scope
                for scope in reversed(scopes):
                    defs = [d for d in (scope.body if isinstance(scope.body, list) else [])
                            if isinstance(d, (ast.FunctionDef, ast.AsyncFunctionDef)) and d.name == fn.id]
                    defs += [d.value for d in (scope.body if isinstance(scope.body, list) else [])
                             if isinstance(d, ast.Assign) and isinstance(d.value, ast.Lambda)
                             and [ast.unparse(t) for t in d.targets] == [fn.id]]
                    if defs:
                        fn, name = defs[-1], fn.id
                        break
            if isinstance(fn, ast.Lambda) and name is None:
                name = f"lambda@{fn.lineno}"
            if name is not None:
                own = _bindings(fn)
                reads = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)}
                state_reads = {n.value.id for n in ast.walk(fn) if isinstance(n, ast.Attribute)
                               and isinstance(n.value, ast.Name) and n.value.id == "state"}
                arrays = []
                for free in sorted(reads - own.keys()):
                    outer = [s for s in reversed(scopes) if s is not fn and free in _bindings(s)]
                    if outer and (_bindings(outer[0])[free] or free in state_reads):
                        arrays.append(free)
                if arrays:
                    top = scopes[1].name if len(scopes) > 1 and hasattr(scopes[1], "name") else name
                    found.append((node.lineno, top, arrays))
        for child in ast.iter_child_nodes(node):
            visit(child, scopes)

    tree = ast.parse(source, filename)
    visit(tree, [tree])
    return found


@pytest.mark.parametrize("source,arrays", [
    ("def f(params):\n  w = jnp.ones(3)\n  g = lambda p: p * w\n  return jax.jit(jax.grad(g))(params)", ["w"]),
    ("def f(params):\n  w = jnp.ones(3)\n  return jax.jit(lambda p: p * w)(params)", ["w"]),
    ("w = np.ones(3)\ndef g(p):\n  return p * w\nf = jax.jit(g)", ["w"]),
    ("def f(state):\n  def loss(p):\n    return p * state.frozen\n  return jax.jit(jax.grad(loss))(state.params)",
     ["state"]),
    ("def f(trainer, x, y):\n  im, tg = trainer.place_batch(x, y)\n  def loss(p):\n    return p * im * tg\n"
     "  return jax.grad(loss)(1.0)", ["im", "tg"]),
    ("def f(state):\n  s = state.batch_stats\n  return jax.value_and_grad(lambda p: p * s)(1.0)", ["s"]),
    ("def f(v):\n  v = jax.tree.map(np.asarray, v)\n  return jax.jit(lambda k: k + v)(0)", ["v"]),
    ("def f(state):\n  def loss(p, frozen, im):\n    return p * frozen * im\n"
     "  return jax.jit(jax.grad(loss))(state.params, state.frozen, jnp.ones(3))", []),
    ("def f(model):\n  return jax.jit(lambda k: model.init(k, jnp.zeros((1, 8, 8, 3))))(0)", []),
    ("def f(amax):\n  return jax.jit(lambda x: x / jnp.float32(amax))(1.0)", []),
    ("def f():\n  x, amax = make_case()\n  return jax.jit(lambda v: v / amax)(x)", ["amax"]),
    ("def f(a, b):\n  args = [jnp.asarray(v) for v in (a, b)]\n  def chain(x):\n    return x * args[0]\n"
     "  return jax.jit(chain)(1.0)", ["args"]),
    ("def f():\n  x = jnp.ones(3)\n  def g(x):\n    return x * 2\n  return jax.jit(g)(x)", []),
], ids=["lambda-named", "lambda", "module-level", "state-attribute", "placed-batch", "state-attribute-named",
        "tree-map", "arrays-as-arguments", "model", "scalar-argument", "unpacked-helper-result", "list-of-arrays",
        "shadowed-by-a-parameter"])
def test_jitted_closure_scan(source, arrays):
    """The scan flags a jitted lambda or function that reads an array of an
    enclosing scope (a jnp / np / jax.device_get / jax.tree.map result, a
    placed batch, a `state` attribute), and not one whose arrays are its
    arguments, nor a closed-over model or scalar."""
    found = _jitted_closures(source)
    assert (found[0][2] if found else []) == arrays


def test_no_port_test_jits_a_closure_over_arrays():
    """No JAX reference in tests/test_torch_*.py is jitted (or
    differentiated) as a closure over arrays built outside it: the arrays
    are its arguments. Parsed, not imported."""
    modules = sorted(Path(__file__).parent.glob("test_torch_*.py"))
    assert len(modules) > 20
    bad, exempt = [], set()
    for path in modules:
        for line, name, arrays in _jitted_closures(path.read_text(), str(path)):
            if (path.name, name) in CLOSURE_EXEMPT:
                exempt.add((path.name, name))
            else:
                bad.append(f"{path.name}:{line} {name} closes over {arrays}")
    assert not bad, "pass these arrays as arguments of the jitted function: " + "; ".join(bad)
    assert exempt == set(CLOSURE_EXEMPT), f"exemptions the scan no longer needs: {set(CLOSURE_EXEMPT) - exempt}"

"""The port imports neither JAX nor the JAX package, nor the repo's root
`tools` package (the port has its own, object_detection_torch2_tpu_torch/tools/):
not at run time (a fresh interpreter imports every module of the port,
chip_smoke.py and kernel_times.py) and not in its
sources (an AST scan of every import statement). Importing it also loads
none of the packages it does not depend on (PIL, msgpack, tqdm); PIL is
imported only inside the functions that decode images (the raw-VOC dataset)
or draw them (utils/render.py). Every port test module caps torch's
intra-op threads, and jits no JAX reference as a closure over arrays (AST
scans). Every port test marked `slow` is listed by its id in chip_smoke.py's
`SLOW_TEST_PHASES` with the phase that holds its checks on the card, and that
phase exists (an AST scan that imports nothing)."""

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


def _is_slow_mark(node) -> bool:
    """`pytest.mark.slow` or `mark.slow`, called or not."""
    if isinstance(node, ast.Call):
        node = node.func
    return (isinstance(node, ast.Attribute) and node.attr == "slow"
            and (isinstance(node.value, ast.Attribute) and node.value.attr == "mark"
                 or isinstance(node.value, ast.Name) and node.value.id == "mark"))


def _is_fixture(node) -> bool:
    """`pytest.fixture` or `fixture`, called or not."""
    if isinstance(node, ast.Call):
        node = node.func
    return (isinstance(node, ast.Attribute) and node.attr == "fixture"
            or isinstance(node, ast.Name) and node.id == "fixture")


# what the card's machine cannot run; the JAX package's utils/testing.py is
# numpy only, and chip_smoke.py keeps its own copy of what it uses of it
JAX_MODULES = ("jax", "jaxlib", "flax", "optax", "object_detection_torch2_tpu")
JAX_PACKAGE_NUMPY_ONLY = "object_detection_torch2_tpu.utils.testing"


def _is_jax_module(name: str) -> bool:
    if name == JAX_PACKAGE_NUMPY_ONLY or name.startswith(JAX_PACKAGE_NUMPY_ONLY + "."):
        return False
    return any(name == m or name.startswith(m + ".") for m in JAX_MODULES)


def _jax_imports(node) -> set:
    """The names that the import statements within `node` bind to the JAX
    package or JAX ("jax" itself included when any is imported)."""
    names = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Import):
            names |= {a.asname or a.name.split(".")[0] for a in n.names if _is_jax_module(a.name)}
        elif isinstance(n, ast.ImportFrom) and n.level == 0 and _is_jax_module(n.module or ""):
            names |= {a.asname or a.name for a in n.names} | {"jax"}
    return names


def _args(fn) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def _slow_tests(source: str, rel: str = "tests/test_torch_x.py") -> dict:
    """{test id: whether it reaches JAX or the JAX package} for each test of a
    module marked `slow`: by a module-level `pytestmark` that is or holds the
    mark, or by a decorator (called or not) on the function, its class or the
    method. A test reaches JAX when its body imports JAX or the JAX package,
    names what the module imports of them, takes a fixture named `jax` or
    `jax_*` that the module does not define, or names or takes a module-level
    function (a helper or a fixture) that reaches them."""
    tree = ast.parse(source, rel)
    module_slow = False
    for node in tree.body:
        if isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else [node.target]
            values = node.value.elts if isinstance(node.value, (ast.List, ast.Tuple)) else [node.value]
            if any(isinstance(t, ast.Name) and t.id == "pytestmark" for t in targets) and any(map(_is_slow_mark,
                                                                                                   values)):
                module_slow = True
    top_jax = _jax_imports(ast.Module(body=[n for n in tree.body if isinstance(n, (ast.Import, ast.ImportFrom))],
                                      type_ignores=[]))
    functions = {n.name: n for n in tree.body if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

    def refs(fn) -> set:
        """The module names that `fn` reads, and the fixtures it takes if it
        is a test or a fixture (a helper's parameters are its own)."""
        own = set(_args(fn)) | {n.id for n in ast.walk(fn) if isinstance(n, ast.Name)
                                and isinstance(n.ctx, ast.Store)}
        read = {n.id for n in ast.walk(fn) if isinstance(n, ast.Name) and isinstance(n.ctx, ast.Load)} - own
        takes = fn.name.startswith("test") or any(map(_is_fixture, fn.decorator_list))
        return read | (set(_args(fn)) if takes else set())

    def direct(fn) -> bool:
        if _jax_imports(fn) or refs(fn) & top_jax:
            return True
        return any(a == "jax" or a.startswith("jax_") for a in _args(fn) if a not in functions)

    reach = {name for name, fn in functions.items() if direct(fn)}
    grew = True
    while grew:
        grown = {name for name, fn in functions.items() if name not in reach and refs(fn) & reach}
        reach |= grown
        grew = bool(grown)
    tests = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) and node.name.startswith("test"):
            if module_slow or any(map(_is_slow_mark, node.decorator_list)):
                tests[f"{rel}::{node.name}"] = node.name in reach
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            class_slow = module_slow or any(map(_is_slow_mark, node.decorator_list))
            for fn in node.body:
                if (isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) and fn.name.startswith("test")
                        and (class_slow or any(map(_is_slow_mark, fn.decorator_list)))):
                    tests[f"{rel}::{node.name}::{fn.name}"] = direct(fn) or bool(refs(fn) & reach)
    return tests


def _slow_test_phases(source: str) -> tuple:
    """chip_smoke.py's `SLOW_TEST_PHASES` ({test id: phase name}, None if it
    has none) and the names of its module-level functions."""
    mapping, functions = None, set()
    for node in ast.parse(source).body:
        if isinstance(node, ast.Assign) and any(isinstance(t, ast.Name) and t.id == "SLOW_TEST_PHASES"
                                                for t in node.targets):
            mapping = ast.literal_eval(node.value)
        elif isinstance(node, ast.FunctionDef):
            functions.add(node.name)
    return mapping, functions


def _unaccounted_slow_marks(tests: dict, smoke_source: str) -> list:
    """What fails the guard, for {"tests/<file>": source} and chip_smoke.py's
    source: a slow test that the mapping lacks, a slow test that reaches JAX
    or the JAX package (the card's machine has neither, so such a test stays
    in the CPU run), a phase that is not a `phase_*` function of
    chip_smoke.py, an entry that is no slow test."""
    mapping, functions = _slow_test_phases(smoke_source)
    if mapping is None:
        return ["chip_smoke.py has no SLOW_TEST_PHASES"]
    slow = {}
    for rel, source in sorted(tests.items()):
        slow.update(_slow_tests(source, rel))
    problems = []
    for test_id, reaches_jax in slow.items():
        if test_id not in mapping:
            problems.append(f"{test_id} is marked slow, and SLOW_TEST_PHASES has no phase for it")
        if reaches_jax:
            problems.append(f"{test_id} is marked slow and reaches JAX or the JAX package: it stays in the CPU run")
    for test_id, phase in sorted(mapping.items()):
        if not (phase.startswith("phase_") and phase in functions):
            problems.append(f"{test_id}: chip_smoke.py has no function {phase!r}")
        if test_id not in slow:
            problems.append(f"{test_id} is in SLOW_TEST_PHASES and is no slow port test")
    return problems


@pytest.mark.parametrize("source,slow", [
    ("import pytest\npytestmark = pytest.mark.slow\ndef test_a():\n  pass\ndef helper():\n  pass", {"test_a": False}),
    ("import pytest\npytestmark = [pytest.mark.cuda, pytest.mark.slow]\ndef test_a():\n  pass", {"test_a": False}),
    ("import pytest\n@pytest.mark.slow\ndef test_a():\n  pass\ndef test_b():\n  pass", {"test_a": False}),
    ("import pytest\n@pytest.mark.slow(reason='x')\n@pytest.mark.parametrize('a', [1])\ndef test_a(a):\n  pass",
     {"test_a": False}),
    ("from pytest import mark\n@mark.slow\nclass TestA:\n  def test_a(self):\n    pass", {"TestA::test_a": False}),
    ("import pytest\npytestmark = pytest.mark.cuda\n@pytest.mark.skipif(True, reason='x')\ndef test_a():\n  pass",
     {}),
    ("import pytest\nclass TestA:\n  @pytest.mark.slow\n  def test_a(self):\n    pass\n  def test_b(self):\n"
     "    pass", {"TestA::test_a": False}),
    ("import pytest\n@pytest.mark.slow\ndef test_a(jax_init):\n  pass", {"test_a": True}),
    ("import pytest\n@pytest.mark.slow\ndef test_a():\n  import jax.numpy as jnp", {"test_a": True}),
    ("import pytest\nfrom object_detection_torch2_tpu.ops import nms\n@pytest.mark.slow\ndef test_a():\n  nms.x()",
     {"test_a": True}),
    ("import pytest\nimport optax\n@pytest.fixture\ndef ref():\n  return optax.sgd(1)\n@pytest.fixture\n"
     "def run(ref):\n  return ref\n@pytest.mark.slow\ndef test_a(run):\n  pass", {"test_a": True}),
    ("import pytest\ndef _ref():\n  from object_detection_torch2_tpu.models.ssd import SSD\n@pytest.mark.slow\n"
     "def test_a():\n  _ref()", {"test_a": True}),
    ("import pytest\nfrom object_detection_torch2_tpu.utils.testing import fingerprint_tree\n"
     "from object_detection_torch2_tpu_torch.models.convert import jax_tree\n@pytest.fixture\ndef jax_like():\n"
     "  return 1\n@pytest.mark.slow\ndef test_a(jax_like):\n  fingerprint_tree(jax_tree({}))", {"test_a": False}),
    ("import pytest\n@pytest.fixture\ndef ref(jax_init):\n  return jax_init\ndef _check(ref):\n  return ref\n"
     "@pytest.mark.slow\ndef test_a():\n  _check(1)", {"test_a": False}),
], ids=["module", "module-list", "decorator", "called-decorator", "from-import-class", "other-marks", "method",
        "jax-fixture", "jax-import-in-test", "jax-package-module", "jax-through-fixtures", "jax-through-helper",
        "numpy-helpers-and-port-names", "helper-parameter-named-as-a-fixture"])
def test_slow_mark_scan(source, slow):
    """The scan finds each test marked slow, by module `pytestmark` (alone or
    in a list) or by a decorator (called or not, on a function, method or
    class), and no other; and whether it reaches JAX or the JAX package: a
    `jax_*` fixture from outside the module, an import in its body, a name
    the module imports from them, or a module fixture or helper that does,
    but not the JAX package's numpy-only utils/testing.py or the port's own
    `jax_*` names."""
    rel = "tests/test_torch_x.py"
    assert _slow_tests(source, rel) == {f"{rel}::{k}": v for k, v in slow.items()}


SLOW_SMOKE = "SLOW_TEST_PHASES = {'tests/test_torch_a.py::test_a': 'phase_a'}\ndef phase_a(card):\n  pass\n"
SLOW_FILE = "import pytest\n@pytest.mark.slow\ndef test_a():\n  pass\n"


@pytest.mark.parametrize("tests,smoke,fails", [
    ({"tests/test_torch_a.py": SLOW_FILE, "tests/test_torch_b.py": "def test_b():\n  pass\n"}, SLOW_SMOKE, []),
    ({"tests/test_torch_a.py": SLOW_FILE, "tests/test_torch_b.py": SLOW_FILE}, SLOW_SMOKE,
     ["tests/test_torch_b.py::test_a is marked slow"]),
    ({"tests/test_torch_a.py": SLOW_FILE + "@pytest.mark.slow\ndef test_c():\n  pass\n"}, SLOW_SMOKE,
     ["tests/test_torch_a.py::test_c is marked slow"]),
    ({"tests/test_torch_a.py": SLOW_FILE}, SLOW_SMOKE.replace("def phase_a", "def other"), ["no function 'phase_a'"]),
    ({"tests/test_torch_a.py": SLOW_FILE}, SLOW_SMOKE.replace("'phase_a'", "'other'").replace("def phase_a", "def other"),
     ["no function 'other'"]),
    ({"tests/test_torch_a.py": "def test_a():\n  pass\n"}, SLOW_SMOKE, ["is no slow port test"]),
    ({"tests/test_torch_a.py": SLOW_FILE}, "def phase_a(card):\n  pass\n", ["has no SLOW_TEST_PHASES"]),
    ({"tests/test_torch_a.py": SLOW_FILE.replace("():", "(jax_init):")}, SLOW_SMOKE, ["reaches JAX"]),
], ids=["accounted", "unlisted-mark", "unlisted-test", "missing-phase", "not-a-phase", "stale-entry", "no-mapping",
        "reaches-jax"])
def test_slow_mark_guard_cases(tests, smoke, fails):
    """The guard passes a slow test listed with an existing phase, and fails
    an unlisted test (in a listed file or another), a missing or misnamed
    phase, a stale entry, a missing mapping and a listed test that reaches
    JAX."""
    problems = _unaccounted_slow_marks(tests, smoke)
    assert len(problems) == len(fails) and all(f in p for f, p in zip(fails, problems)), problems


def test_every_slow_mark_has_its_chip_smoke_phase():
    """Each port test marked slow (left out of the default CPU run) is listed
    by its id in chip_smoke.py's SLOW_TEST_PHASES with the `phase_*` function
    that holds its checks on the card, that function exists, and no such
    test reaches JAX or the JAX package. Parsed, not imported."""
    tests = {f"tests/{p.name}": p.read_text() for p in sorted(Path(__file__).parent.glob("test_torch_*.py"))}
    assert len(tests) > 20
    problems = _unaccounted_slow_marks(tests, (ROOT / "chip_smoke.py").read_text())
    assert not problems, "; ".join(problems)

"""Builds the package's CUDA kernels from `csrc/*.cu` at first use.

Each source is compiled by nvcc into its own shared library with a plain C
interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 <the source's own flags>
         -shared -Xcompiler -fPIC -o <build>/<hash>/lib<name>.so csrc/<name>.cu

A source's own flags are in `SOURCE_FLAGS`: the NMS sweep is built with
`-fmad=false` so that it rounds as its plain version does; the two conv_1_2
kernels are built with FMA contraction, as a convolution's sum should be; the
int8 convolution sums in int32 and writes its float epilogue with explicit
round-to-nearest intrinsics, which no flag changes, and so do the
activation quantize (`__fdiv_rn`, `__frcp_rn`, `__fmul_rn`) and the
BatchNorm moments (the square by `__fmul_rn` / `__dmul_rn`, then float64
adds).
`tensor_core_instructions` counts the tensor-core instructions in a built
library's machine code (cuobjdump -sass): HMMA (mma.sync on floating-point
types), HGMMA (wgmma on them), IMMA (mma.sync on int8) and IGMMA (wgmma on
int8).

The output lands in `object_detection_torch2_tpu_torch/_build/`, in a
directory keyed by a hash of that source, the shared headers and its flags, so
an edited source is rebuilt and an unchanged one is not. `build_all()` starts
one nvcc per source, all at once. A failed build raises with nvcc's stderr.
Nothing is downloaded.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC = PACKAGE_DIR / "csrc"
BUILD_ROOT = PACKAGE_DIR / "_build"
DEFAULT_CUDA_HOME = "/usr/local/cuda"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# -fmad=false: no FMA contraction, so the NMS sweep rounds as its plain
# PyTorch version does, bit for bit (IEEE division is nvcc's default without
# --use_fast_math)
SOURCE_FLAGS = {"nms_keep_sorted": ("-fmad=false",)}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + SOURCE_FLAGS.get(name, ())


def build_dir(name: str) -> Path:
    """The build directory of csrc/<name>.cu: keyed by its flags, its own
    bytes and those of the shared headers."""
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")) + sorted(CSRC.glob("*.h")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def find_tool(name: str) -> str:
    for cand in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH"), DEFAULT_CUDA_HOME):
        if cand and (Path(cand) / "bin" / name).is_file():
            return str(Path(cand) / "bin" / name)
    found = shutil.which(name)
    if found is None:
        raise RuntimeError(f"{name} not found (looked in $CUDA_HOME, $CUDA_PATH, {DEFAULT_CUDA_HOME} and $PATH); "
                           "the CUDA kernels are built on a machine with the CUDA toolkit")
    return found


def nvcc_command(nvcc: str, src: Path, out: Path) -> list[str]:
    return [nvcc, *flags(src.stem), "-o", str(out), str(src)]


def library_path(name: str) -> Path:
    return build_dir(name) / f"lib{name}.so"


def build_all() -> dict[str, str]:
    """Build every source that is not built yet, one nvcc per source, all
    started together. Returns {name: nvcc's output (ptxas register and shared
    memory report)} for the sources built by this call."""
    todo = [s for s in sources() if not library_path(s.stem).is_file()]
    if not todo:
        return {}
    nvcc = find_tool("nvcc")
    procs = {}
    for src in todo:
        out_dir = build_dir(src.stem)
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
        procs[src.stem] = (tmp, subprocess.Popen(nvcc_command(nvcc, src, tmp), stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        stdout, stderr = proc.communicate()
        logs[name] = stdout + stderr
        if proc.returncode != 0:
            failed.append(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{stderr}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, library_path(name))  # atomic: two processes building at once race harmlessly
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The shared library of csrc/<name>.cu, built first if needed."""
    if not (CSRC / f"{name}.cu").is_file():
        raise FileNotFoundError(f"no kernel source csrc/{name}.cu")
    if not library_path(name).is_file():
        build_all()
    return ctypes.CDLL(str(library_path(name)))


TENSOR_CORE_OPCODES = ("HMMA", "HGMMA", "IMMA", "IGMMA")
# an instruction of cuobjdump -sass: `/*0a40*/  @!P0 HMMA.16816.F32.BF16 R24, ...`,
# its address, an optional predicate guard, then the opcode up to its first dot
_SASS_OPCODE = re.compile(r"/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")


def count_tensor_core_opcodes(sass: str) -> dict[str, int]:
    """{HMMA, HGMMA, IMMA, IGMMA: instructions} in cuobjdump -sass text."""
    ops = _SASS_OPCODE.findall(sass)
    return {op: ops.count(op) for op in TENSOR_CORE_OPCODES}


def tensor_core_instructions(name: str) -> dict[str, int]:
    """{HMMA, HGMMA, IMMA, IGMMA: count} in the machine code of csrc/<name>.cu's built library."""
    lib = library_path(name)
    if not lib.is_file():
        raise FileNotFoundError(f"csrc/{name}.cu is not built ({lib})")
    out = subprocess.run([find_tool("cuobjdump"), "-sass", str(lib)], capture_output=True, text=True,
                         check=True, timeout=120)
    return count_tensor_core_opcodes(out.stdout)

"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point
(no PyTorch headers, so a build takes seconds).  At first use it is
compiled for Hopper (``-gencode arch=compute_90a,code=sm_90a``) into
``build/repro_torch/<name>.so`` under the repository root, which
``.gitignore`` lists; a library older than any of its sources is
rebuilt.  Only the repository's own sources are read.

Each batch of ``nvcc`` processes runs inside the ``obs`` span
``kernels.build`` (attr ``names``), so a request slowed by a first
build, or a kernel built again, shows by name in a trace.

Calling convention of every entry point: pointers and the stream are
``c_void_p``, sizes ``c_int64``; the launch runs on the caller's stream
(``torch.cuda.current_stream()``) and the function returns
``cudaGetLastError()``, which the wrapper turns into a
:class:`~repro_torch.resilience.errors.CudaLaunchError`.
"""
from __future__ import annotations

import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

from .. import obs
from ..resilience.errors import CudaLaunchError

_KERNELS = Path(__file__).resolve().parent
_ROOT = _KERNELS.parents[2]
BUILD_DIR = _ROOT / "build" / "repro_torch"
_SHARED = _KERNELS / "csrc"

#: kernel name -> its .cu source
SOURCES = {
    "interval_weight": _KERNELS / "interval_weight" / "csrc"
    / "interval_weight.cu",
    "tree_sampler": _KERNELS / "tree_sampler" / "csrc" / "tree_sampler.cu",
    "flash_attention": _KERNELS / "flash_attention" / "csrc"
    / "flash_attention.cu",
    "flash_attention_sm90": _KERNELS / "flash_attention" / "csrc"
    / "flash_attention_sm90.cu",
    "segment_matmul": _KERNELS / "segment_matmul" / "csrc"
    / "segment_matmul.cu",
    "segment_matmul_sm90": _KERNELS / "segment_matmul" / "csrc"
    / "segment_matmul_sm90.cu",
    "embedding_bag": _KERNELS / "embedding_bag" / "csrc"
    / "embedding_bag.cu",
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel name -> the compiler's output of its last build in this process
#: (``-Xptxas -v``: each entry's registers, shared memory and spills)
REPORTS: dict[str, str] = {}

#: kernels compiled and libraries loaded in this process
#: (``analysis.no_rebuild`` reads them)
COUNTS = {"builds": 0, "loads": 0}


def nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default place."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (run on the CPU with device='cpu')")


def _deps(name: str) -> list[Path]:
    return [SOURCES[name], *sorted(_SHARED.glob("*.cuh"))]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}.so"


def _stale(name: str) -> bool:
    lib = library_path(name)
    if not lib.exists():
        return True
    built = lib.stat().st_mtime
    return any(p.stat().st_mtime > built for p in _deps(name))


def _start(name: str) -> tuple[subprocess.Popen, Path]:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{name}.{os.getpid()}.tmp.so"
    cmd = [nvcc(), *NVCC_FLAGS, "-I", str(_SHARED), "-o", str(tmp),
           str(SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp


def build(names=None) -> list[str]:
    """Compile every stale kernel, all ``nvcc`` processes started at once.

    Returns the names that were compiled; raises with the compiler's
    output if any build fails.
    """
    todo = [n for n in (SOURCES if names is None else names) if _stale(n)]
    if not todo:
        return todo
    with obs.span("kernels.build", names=list(todo)):
        started = {n: _start(n) for n in todo}
        COUNTS["builds"] += len(todo)
        errors = []
        for name, (proc, tmp) in started.items():
            out, _ = proc.communicate()
            REPORTS[name] = out
            if proc.returncode != 0:
                errors.append(f"nvcc {name} (exit {proc.returncode}):"
                              f"\n{out}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, library_path(name))
        if errors:
            raise RuntimeError("\n".join(errors))
    return todo


_LIBS: dict[str, ctypes.CDLL] = {}


def ptxas_usage(report: str) -> dict:
    """``{entry: {"registers": r, "spill_stores": s, "spill_loads": l}}``
    from the ``-Xptxas -v`` lines of a build's output (mangled entry
    names)."""
    out, entry = {}, None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = dict(registers=None, spill_stores=0, spill_loads=0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and entry:
            out[entry].update(spill_stores=int(m.group(1)),
                              spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry]["registers"] = int(m.group(1))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library, built first when missing or stale."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library_path(name)))
        COUNTS["loads"] += 1
        _LIBS[name] = lib
    return lib


def loaded() -> list[str]:
    """The kernels whose library this process has loaded."""
    return list(_LIBS)


def check(rc: int, name: str) -> None:
    """Raise :class:`~repro_torch.resilience.errors.CudaLaunchError`
    (a ``RuntimeError`` carrying the number, which the failure taxonomy
    classifies) on a non-zero ``cudaError_t`` returned by an entry
    point."""
    if rc != 0:
        raise CudaLaunchError(name, rc)

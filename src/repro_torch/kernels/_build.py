"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with :mod:`ctypes`. The
build runs at first use into ``build/repro_torch_kernels/<hash>/`` at the
root of the checkout, keyed by a hash of every source and the compiler
flags, so an edited kernel never loads a stale library. nvcc's register
report is kept beside each library (:func:`report`). A failed build raises
with nvcc's output; nothing falls back to the plain version.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`launch` raises when that is not 0 and otherwise adds one to the
op's launch count (:func:`launch_counts`), so a run can show that it went
through the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from collections import Counter
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("affinity", "power_step", "kmeans_assign", "streaming", "gram", "row_topk",
           "block_sparse", "flash_attention")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: the ops whose launches are counted, one per kernel entry point
OPS = ("affinity_and_degree", "degree_normalized_matmat", "kmeans_assign",
       "streaming_matmat", "streaming_degree", "gram", "row_topk", "block_liveness",
       "block_sparse_matmat", "block_sparse_streaming_matmat",
       "block_sparse_streaming_degree", "flash_attention")

_LIBS: dict[str, ctypes.CDLL] = {}
_FNS: dict[tuple[str, str], object] = {}   # the typed C entry points
_LOCK = threading.Lock()
_COUNTS: Counter = Counter()


def nvcc_path() -> str:
    """The CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def build_dir() -> Path:
    """The build directory for the current sources and flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.iterdir()):
        if src.suffix in (".cu", ".cuh"):
            h.update(src.name.encode())
            h.update(src.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def _lib_path(name: str) -> Path:
    return build_dir() / f"lib{name}.so"


def _report_path(name: str) -> Path:
    return build_dir() / f"lib{name}.ptxas.txt"


def report(name: str) -> str:
    """nvcc's output (the ``-Xptxas -v`` register and shared-memory report)
    from the build of library ``name``, kept beside it; raises
    FileNotFoundError if the library is not built."""
    return _report_path(name).read_text()


def build(names=SOURCES) -> dict[str, str]:
    """Compile the named sources that are not built yet, one ``nvcc`` per
    source, all started together. Returns ``{name: compiler output}`` for
    what it built (:func:`report` reads it back later); raises RuntimeError
    with nvcc's output if any build fails."""
    out_dir = build_dir()
    todo = [n for n in names if not (_lib_path(n).exists() and _report_path(n).exists())]
    if not todo:
        return {}
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name in todo:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(CSRC / f"{name}.cu")]
        try:
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            os.unlink(tmp)
            raise RuntimeError(f"cannot run the CUDA compiler {nvcc!r}: {e}") from e
        procs[name] = (proc, tmp)
    logs, failed = {}, []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"--- nvcc {name}.cu (exit {proc.returncode}) ---\n{log}")
            os.unlink(tmp)
        else:
            _report_path(name).write_text(log)
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            lib.gpic_error_string.argtypes = [ctypes.c_int]
            lib.gpic_error_string.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def launch(op: str, lib_name: str, fn_name: str, argtypes, *args) -> None:
    """Call the C entry point ``fn_name`` of ``lib_name`` (typed with
    ``argtypes`` at its first call), raise if it reports a CUDA error, and
    count the launch under ``op``."""
    fn = _FNS.get((lib_name, fn_name))
    if fn is None:
        fn = getattr(library(lib_name), fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _FNS[(lib_name, fn_name)] = fn
    err = fn(*args)
    if err != 0:
        msg = library(lib_name).gpic_error_string(err).decode()
        raise RuntimeError(f"{fn_name} failed to launch: CUDA error {err} ({msg})")
    _COUNTS[op] += 1


def launch_counts() -> dict[str, int]:
    """Kernel launches per op since the last :func:`reset_launch_counts`."""
    return {op: _COUNTS[op] for op in OPS}


def reset_launch_counts() -> None:
    _COUNTS.clear()

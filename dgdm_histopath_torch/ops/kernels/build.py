"""Build the CUDA sources under ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` exports a plain C entry point and becomes its own
shared library, ``build/<name>-<hash>.so``, where the hash covers the
source and the flags: a changed source builds anew, an unchanged one is
reused. Nothing is built when a module is imported; the first launch of a
kernel builds its library (``build_all`` builds every source at once, one
nvcc process per source, all started together).

Sources are compiled for Hopper only (``sm_90a``), with ``-Xptxas -v``:
nvcc's output is kept beside each library (``build/<name>-<hash>.log``) and
:func:`ptxas_report` reads each kernel's registers, spills and shared memory
from it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
# guards the launch counters: threads (the quality gates' thread mode) launch at once
_count_lock = threading.Lock()

# the element type of a kernel's float operands, as every launch takes it
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def dtype_code(dtype: torch.dtype) -> int:
    return DTYPE_CODES[dtype]


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and PATH); "
                           "the CUDA kernels cannot be built")
    return found


def sources() -> List[Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(source: Path) -> Path:
    digest = hashlib.sha256(source.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{digest.hexdigest()[:16]}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Build the named sources (default: every ``csrc/*.cu``) that have no
    library for their current hash. Returns ``{name: library path}``."""
    wanted = set(names) if names is not None else None
    todo = {s.stem: s for s in sources() if wanted is None or s.stem in wanted}
    if wanted is not None and set(todo) != wanted:
        raise FileNotFoundError(f"no CUDA source for {sorted(wanted - set(todo))}")
    libs = {name: library_path(src) for name, src in todo.items()}
    with _lock:
        missing = {n: s for n, s in todo.items() if not libs[n].exists()}
        if not missing:
            return libs
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = nvcc_path()
        procs = {}
        for name, src in missing.items():
            tmp = libs[name].with_suffix(f".{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failures = []
        for name, (tmp, proc) in procs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            else:
                libs[name].with_suffix(".log").write_text(log)
                os.replace(tmp, libs[name])   # atomic: readers never see half a file
        if failures:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failures))
    return libs


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_USED = re.compile(r"Used (\d+) registers")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads")
_SMEM = re.compile(r"(\d+) bytes smem")


def demangle(names: List[str]) -> List[str]:
    """Kernel names through ``cu++filt -p`` (beside nvcc); the mangled names
    as they are where it cannot run."""
    try:
        res = subprocess.run([str(Path(nvcc_path()).with_name("cu++filt")), "-p", *names],
                             capture_output=True, text=True, check=True, timeout=60)
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return names
    out = res.stdout.splitlines()
    return out if len(out) == len(names) else names


def ptxas_report(name: str) -> List[Dict]:
    """What ptxas said of each kernel of ``csrc/<name>.cu`` when its library
    was built: ``[{"kernel", "registers", "spill_stores", "spill_loads",
    "stack", "static_smem"}]``. Dynamic shared memory is the launcher's and
    not in it."""
    log = build_all([name])[name].with_suffix(".log")
    out: List[Dict] = []
    for line in (log.read_text().splitlines() if log.exists() else []):
        if (m := _ENTRY.search(line)):
            out.append({"kernel": m.group(1), "registers": None,
                        "spill_stores": None, "spill_loads": None, "stack": None,
                        "static_smem": 0})
        elif out and (m := _SPILL.search(line)):
            out[-1].update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                           spill_loads=int(m.group(3)))
        elif out and (m := _USED.search(line)):
            out[-1]["registers"] = int(m.group(1))
            if (sm := _SMEM.search(line)):
                out[-1]["static_smem"] = int(sm.group(1))
    for r, label in zip(out, demangle([r["kernel"] for r in out])):
        r["kernel"] = label
    return out


class CudaKernel:
    """One C entry point of one ``csrc`` source, loaded at first launch.

    ``launches`` counts the launches this process made through
    :meth:`launch`; a launch that returns a CUDA error raises and is not
    counted.
    """

    def __init__(self, source: str, symbol: str, argtypes: List):
        self.source = source
        self.symbol = symbol
        self.argtypes = argtypes
        self.launches = 0
        self._fn = None
        self._lib = None

    def _load(self):
        if self._fn is None:
            path = build_all([self.source])[self.source]
            lib = ctypes.CDLL(str(path))
            fn = getattr(lib, self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            err = lib.kernel_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            self._lib, self._fn = lib, fn
        return self._fn

    def launch(self, *args) -> None:
        rc = self._load()(*args)
        if rc != 0:
            msg = self._lib.kernel_error_string(rc).decode()
            raise RuntimeError(f"{self.symbol} failed: CUDA error {rc} ({msg})")
        with _count_lock:
            self.launches += 1

"""Build and load the port's CUDA kernels.

Each source in `sstts_torch/csrc/` compiles with `nvcc` for `sm_90a` into a
shared library with a plain C interface, loaded with `ctypes` (no PyTorch
headers, so a build takes seconds).  Libraries are named by a hash of their
source and the shared headers (`csrc/*.cuh`), under `sstts_torch/_build/`
(git-ignored), and built on first use; `build_all` starts one `nvcc` per
source, all at once.  The compiler's output (`-Xptxas -v`: each kernel's
registers, shared memory and spills) is kept beside the library as
`lib<name>-<hash>.log`; `ptxas_report` reads it.

Nothing here runs at import time: the CPU tests import every module of the
port on hosts with no `nvcc` and no card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = ("gru", "decoder", "gl_semi", "teacher", "reproject", "gl_fused")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Shared memory one block may use on the H100 (the 227 KB opt-in).
MAX_SMEM = 232448

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of `nvcc`: $CUDA_HOME/bin, then PATH, then /usr/local/cuda."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        Path(home) / "bin" / "nvcc" if home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME); the sstts_torch CUDA kernels are "
        "built from sstts_torch/csrc on first use"
    )


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_all(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every missing library, one `nvcc` per source, all started
    together; raise with the compiler's output if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (rc {proc.returncode}) ---\n{log}")
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: no process loads a half-written file
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


_PTXAS_ENTRY = re.compile(
    r"Compiling entry function '(?P<name>\w+)' for 'sm_90a'.*?"
    r"(?P<stack>\d+) bytes stack frame, (?P<stores>\d+) bytes spill stores, "
    r"(?P<loads>\d+) bytes spill loads.*?Used (?P<regs>\d+) registers",
    re.S,
)


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """What ptxas said of each kernel of `csrc/<name>.cu` when the library
    was built: mangled kernel name -> registers a thread, bytes of stack,
    and bytes of spill stores and loads."""
    path = library_path(name)
    if not path.exists():
        build_all([name])
    log = path.with_suffix(".log").read_text()
    return {
        m["name"]: {
            "registers": int(m["regs"]), "stack_bytes": int(m["stack"]),
            "spill_store_bytes": int(m["stores"]),
            "spill_load_bytes": int(m["loads"]),
        }
        for m in _PTXAS_ENTRY.finditer(log)
    }


def load(name: str, signatures: Dict[str, tuple]) -> ctypes.CDLL:
    """The loaded library for `csrc/<name>.cu`, building it if needed.

    `signatures` maps each exported function to (argtypes, restype); every
    pointer is `c_void_p` so that ctypes never truncates it to 32 bits.
    """
    if name not in _loaded:
        path = library_path(name)
        if not path.exists():
            build_all([name])
        lib = ctypes.CDLL(str(path))
        sigs = {"sstts_error_string": ([ctypes.c_int], ctypes.c_char_p)}
        sigs.update(signatures)
        for fn, (argtypes, restype) in sigs.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        _loaded[name] = lib
    return _loaded[name]


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launch returned a CUDA error (a refused launch never runs,
    and a later synchronize would not report it)."""
    if rc != 0:
        msg = lib.sstts_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")

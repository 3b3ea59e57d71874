"""Build and load the hand-written CUDA kernels under ``csrc/``.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), cached in
``<repo>/build/kernels/`` under a hash of the sources and flags, and loaded
with ``ctypes``. :func:`build_all` starts one ``nvcc`` per source, all at
once, and waits for them. Nothing builds at import time; a missing
``nvcc`` raises.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
KERNELS = ("paged_kv_attention", "quant_cast", "pack", "quant_matmul")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                           "source and need the CUDA toolkit")
    return path


def library_path(name: str) -> Path:
    """Cache path of kernel ``name``'s library: keyed by its source, every
    header in ``csrc/`` and the compiler flags."""
    h = hashlib.sha256()
    for src in [CSRC / f"{name}.cu"] + sorted(CSRC.glob("*.cuh")):
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = KERNELS) -> Dict[str, float]:
    """Compile every kernel in ``names`` whose library is not cached yet,
    one ``nvcc`` process per source, all started together. Returns the
    wall seconds of each build started (cached libraries are absent).
    Each library's compiler output (``-Xptxas=-v``: registers, shared
    memory and spills per kernel) is kept beside it, see
    :func:`ptxas_report`."""
    todo = [(n, library_path(n)) for n in names]
    todo = [(n, p) for n, p in todo if not p.exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    t0 = time.perf_counter()
    for name, path in todo:
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    times, errors = {}, []
    for name, path, tmp, proc in procs:
        log, _ = proc.communicate()
        times[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}:\n{log}")
            continue
        path.with_suffix(".log").write_text(log)
        os.replace(tmp, path)
    if errors:
        raise RuntimeError("\n".join(errors))
    return times


def ptxas_report(name: str) -> list:
    """ptxas's per-kernel lines for kernel ``name``'s cached library:
    (mangled kernel name, its "Used ..." line with registers and shared
    memory, and its spill line), from the build's log."""
    log = library_path(name).with_suffix(".log")
    if not log.exists():
        return []
    out, fn, spill = [], None, ""
    for line in log.read_text().splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line.split()[-1]
        elif "spill stores" in line:
            spill = line.split("ptxas info    :")[-1].strip()
        elif "Used" in line and "registers" in line and fn is not None:
            out.append((fn, line.split("ptxas info    :")[-1].strip(), spill))
            fn, spill = None, ""
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib


def check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    """Raise if a launch function of kernel ``name`` returned a non-zero
    ``cudaError_t`` (its library exports ``<name>_error_string``)."""
    if err != 0:
        fn = getattr(lib, f"{name}_error_string")
        fn.argtypes = [ctypes.c_int]
        fn.restype = ctypes.c_char_p
        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{fn(err).decode()}")


@functools.lru_cache(maxsize=None)
def num_sms(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (grid-stride
    kernels launch a few blocks per SM)."""
    import torch
    return torch.cuda.get_device_properties(index).multi_processor_count


def refuse_fake(*tensors) -> None:
    """Raise when a fake tensor (the dry run's, ``launch.dryrun``)
    reaches a kernel wrapper: the ``ctypes`` launch is invisible to the
    op-cost recorder and cannot run on fake data, and the plain version
    would hide the kernel from the count."""
    from torch._subclasses.fake_tensor import FakeTensor
    if any(isinstance(t, FakeTensor) for t in tensors):
        raise RuntimeError("a fake tensor reached a CUDA kernel's wrapper: "
                           "the dry run's cells must not reach a kernel")

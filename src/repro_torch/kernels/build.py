"""Build the hand-written CUDA kernels from ``csrc/`` and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``.  Nothing is
built when a module is imported: the first wrapper call on a CUDA tensor
builds (or reuses) the library.  Libraries go to ``kernels/_build/`` (listed
in ``.gitignore``) under a name that carries a hash of the source, the
headers (``*.cuh``) of its directory and the flags, so an edited source or
header is never served from a stale build.

``build(names)`` starts one ``nvcc`` per source, all at once, and waits for
them together; ``chip_smoke.py`` calls it up front to time the build.  Both
take another source directory as ``csrc`` (``chip_smoke.py`` builds the
earlier kernels kept under ``tools/earlier/`` that way, to time them).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[tuple[str, str], ctypes.CDLL] = {}
# nvcc's output (incl. -Xptxas -v) per build: by name, or "<dir>/<name>"
# for a source outside csrc/
build_logs: dict[str, str] = {}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(name: str, csrc: Path) -> Path:
    src = (csrc / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(csrc.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names, csrc: Path = CSRC) -> dict[str, Path]:
    """Compile every listed kernel that has no current build, in parallel.

    Returns ``{name: library path}``; raises with nvcc's output on failure.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    csrc = Path(csrc)
    targets = {name: _target(name, csrc) for name in names}
    procs = {}
    for name, target in targets.items():
        if target.exists():
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    failed = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        build_logs[name if csrc == CSRC else f"{csrc.name}/{name}"] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, targets[name])
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return targets


def device_and_stream(t) -> tuple[int, int]:
    """The CUDA device index of tensor ``t`` and the handle of PyTorch's
    current stream on it, as a launch function takes them."""
    dev = t.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    return dev, torch.cuda.current_stream(dev).cuda_stream


def load(name: str, csrc: Path = CSRC) -> ctypes.CDLL:
    """The loaded library for ``<csrc>/<name>.cu``, built on first use."""
    key = (str(csrc), name)
    lib = _loaded.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build([name], csrc)[name]))
        _loaded[key] = lib
    return lib

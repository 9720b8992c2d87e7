"""Build and load the port's CUDA kernels (plain C interface + ctypes).

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into its own
shared library under ``_build/`` beside the sources (listed in
``.gitignore``), named by a hash of the source, the shared ``csrc/*.cuh``
headers and the flags, so a changed source or header never loads a stale
library. All sources build at once, one ``nvcc`` process each, at first
use; nothing is built or imported when the module is imported. A source
that fails to build raises: there is no fallback.

The wrappers share :func:`route` (a CPU tensor takes the plain version, a
CUDA tensor the kernel) and :func:`launch`, which runs a kernel on the
current CUDA stream, raises on a launch error and adds one to the kernel's
``LAUNCHES`` count, so a run can show that its path went through it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# argtypes of each library's launch function (pointers and the stream as
# c_void_p, so ctypes never truncates them to 32-bit ints)
_P, _I = ctypes.c_void_p, ctypes.c_int
SIGNATURES = {
    "bank_prefix_hamming": (_P, _P, _P, _I, _I, _I, _I, _P),
    "sign_project_pack": (_P, _P, _P, _I, _I, _I, _P),
    "fused_scores": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "delta_update": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "packed_hamming_batched": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "sign_project": (_P, _P, _P, _I, _I, _I, _P),
}

LAUNCHES = {name: 0 for name in SIGNATURES}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    cands = [os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc")] \
        if os.environ.get("CUDA_HOME") else []
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from source at first use")


def _target(name: str) -> Path:
    """The library of kernel ``name``, tagged by its source, every shared
    header in ``csrc/`` (a ``.cu`` may include any of them) and the flags."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, str]:
    """Compile every kernel whose library is missing, all in parallel, and
    load them. Returns ``{name: ptxas report}`` for the sources built by
    this call (empty when everything was already loaded)."""
    with _lock:
        todo = [n for n in SIGNATURES if n not in _libs]
        reports: dict[str, str] = {}
        procs = {}
        if todo:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
        for n in todo:
            out = _target(n)
            if out.exists():
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                   str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT, text=True),
                        tmp, out)
        failed = []
        for n, (p, tmp, out) in procs.items():
            log, _ = p.communicate()
            reports[n] = log
            if p.returncode != 0:
                failed.append(f"{n}: nvcc exited {p.returncode}\n{log}")
            else:
                os.replace(tmp, out)   # atomic: concurrent builds agree
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        for n in todo:
            lib = ctypes.CDLL(str(_target(n)))
            fn = getattr(lib, f"{n}_launch")
            fn.argtypes = SIGNATURES[n]
            fn.restype = ctypes.c_int
            _libs[n] = lib
        return reports


def launch_fn(name: str):
    """The C launch function of kernel ``name``, building it if needed."""
    if name not in _libs:
        build_all()
    return getattr(_libs[name], f"{name}_launch")


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def route(name: str, *tensors) -> bool:
    """True to launch the CUDA kernel, False for the plain CPU version."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"{name}: inputs on different devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dev}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    return True


def launch(name: str, device, *args) -> None:
    """Run kernel ``name`` on ``device``'s current stream with ``args``
    (tensors pass their data pointers); raise if the launch failed."""
    import torch

    fn = launch_fn(name)
    ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(device):
        err = fn(*ptrs, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {err}")
    LAUNCHES[name] += 1

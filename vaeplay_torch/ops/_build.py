"""Build the port's CUDA sources and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface. `nvcc` compiles it for
Hopper (`sm_90a`) into `vaeplay_torch/_build/<name>-<digest>.so`, where the
digest covers the source, the headers beside it (`*.cuh`) and the flags, so
an edited source or header is rebuilt and a built one is reused. Nothing
here runs at import time: the first `load` of a library builds it, and
`build` starts one `nvcc` per source, all at once.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _I64P = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
# The C functions of each library: name -> (argtypes, restype).
SIGNATURES = {
    "flash_attention": {
        # q, k, v, out, lse (or null), b, n, dk, dv, strides[12], direct, stream (f32)
        "flash_attention_fwd": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I64P, _I, _P], _I),
    },
    "flash_attention_bf16": {
        # the same arguments, bf16 tensors
        "flash_attention_fwd_bf16": ([_P, _P, _P, _P, _P, _I, _I, _I, _I, _I64P, _I, _P], _I),
    },
    "flash_attention_bwd": {
        # q, k, v, out, g, lse, delta, dq_acc, dk_acc, dq, dk, dv, b, n, dk, dv,
        # strides[24], stream
        "flash_attention_bwd": ([_P] * 12 + [_I, _I, _I, _I, _I64P, _P], _I),
        # the same arguments, bf16 tensors (lse, delta, dq_acc, dk_acc f32)
        "flash_attention_bwd_bf16": ([_P] * 12 + [_I, _I, _I, _I, _I64P, _P], _I),
    },
}

_LOADED: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.isfile(path):
        return path
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                           "the CUDA toolkit is installed")
    return found


def library_path(name: str, csrc: Path = CSRC) -> Path:
    src = b"".join(f.read_bytes() for f in [csrc / f"{name}.cu", *sorted(csrc.glob("*.cuh"))])
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None, csrc: Path = CSRC) -> Dict[str, dict]:
    """Compile the named sources of `csrc` (default: all of the port's) that
    are not built yet, one `nvcc` process per source, all started together.
    Returns, per name, the build's wall seconds (0.0 when it was already
    built) and the compiler's log (ptxas's register and shared-memory
    report). Raises with the compiler's output when a build fails."""
    names = sorted(SIGNATURES) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs, report = {}, {}
    start = time.perf_counter()
    for name in names:
        out = library_path(name, csrc)
        if out.exists():
            report[name] = {"seconds": 0.0, "log": ""}
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(csrc / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - start, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built on first use, with its C signatures set."""
    with _LOCK:
        lib = _LOADED.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, (argtypes, restype) in SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _LOADED[name] = lib
        return lib

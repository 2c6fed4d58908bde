"""Build, load and count the port's CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into its own shared library, loaded with ``ctypes``. The build
happens on first use, never at import: one ``nvcc`` per source, all started
together, into ``build/repro_torch/`` at the root of the checkout (listed in
``.gitignore``). A library's file name carries a hash of its source, of
every ``csrc`` header it includes (``#include "..."``, followed through
headers) and of the flags, so an edited source or header is rebuilt and an
unchanged one is reused.

There is no fast-math and no TF32 anywhere: the scorer's features feed
``>=`` threshold compares, where one ulp flips a leaf.

``launch_counts`` holds one plain integer per kernel; a wrapper adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels. ``geometry_counts`` splits the two
scorers' launches by corpus geometry (``shared`` or ``gathered``).
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

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
KERNELS = ("fused_score", "minhash", "lsh_probe", "lsh_probe_gathered",
           "fused_score_q", "profile_distance", "gbdt_infer", "quality_cdf")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# dynamic shared memory a block may hold on sm_90 (227 KB)
MAX_SMEM = 232_448

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# C signature of each kernel's entry points: name -> (argtypes, restype)
_SIGNATURES = {
    "fused_score": {
        "freyja_fused_score": ([_P] * 7 + [_F, _P, _I, _I, _LL, _I, _I, _P], _I),
        "freyja_fused_score_smem": ([_I, _I], _LL),
    },
    "minhash": {
        "freyja_minhash": ([_P] * 4 + [_I, _I, _I, _P], _I),
    },
    "lsh_probe": {
        "freyja_lsh_probe": ([_P] * 3 + [_I, _I, _I, _P], _I),
        "freyja_lsh_probe_max_bands": ([], _I),
    },
    "lsh_probe_gathered": {
        "freyja_lsh_probe_gathered": ([_P] * 3 + [_I, _I, _I, _P], _I),
        "freyja_lsh_probe_gathered_max_bands": ([], _I),
    },
    "fused_score_q": {
        "freyja_fused_score_q": ([_P] * 8 + [_F, _P, _I, _I, _LL, _I, _I, _I, _P], _I),
        "freyja_fused_score_q_smem": ([_I, _I], _LL),
    },
    "profile_distance": {
        "freyja_profile_distance": ([_P] * 5 + [_I, _I, _P], _I),
    },
    "gbdt_infer": {
        "freyja_gbdt_infer": ([_P] * 4 + [_F, _P, _LL, _I, _I, _I, _P], _I),
        "freyja_gbdt_infer_smem": ([_I, _I, _I], _LL),
    },
    "quality_cdf": {
        "freyja_quality_cdf": ([_P] * 3 + [_LL] + [_F] * 8 + [_P], _I),
    },
}
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)

launch_counts = {name: 0 for name in KERNELS}
geometry_counts = {name: {"shared": 0, "gathered": 0}
                   for name in ("fused_score", "fused_score_q")}
_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def reset_launch_counts() -> None:
    for name in KERNELS:
        launch_counts[name] = 0
    for split in geometry_counts.values():
        split.update(shared=0, gathered=0)


def count_launch(name: str, geometry: str | None = None) -> None:
    launch_counts[name] += 1
    if geometry is not None:
        geometry_counts[name][geometry] += 1


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME:
        path = Path(CUDA_HOME) / "bin" / "nvcc"
        if path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def sources(name: str) -> list[str]:
    """Kernel ``name``'s ``.cu`` file and every ``csrc`` header it includes
    with quotes, directly or through another header, sorted."""
    seen, todo = set(), [f"{name}.cu"]
    while todo:
        f = todo.pop()
        if f not in seen:
            seen.add(f)
            todo += [m.decode() for m in _LOCAL_INCLUDE.findall((_CSRC / f).read_bytes())]
    return sorted(seen)


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for f in sources(name):
        h.update(f.encode() + b"\0" + (_CSRC / f).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, Path]:
    """Compile every missing kernel library, one ``nvcc`` per source, all
    running at once. Returns name -> library path."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    paths = {name: library_path(name) for name in KERNELS}
    procs = {}
    nvcc = None
    for name, path in paths.items():
        if path.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.STDOUT))
    errors = []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out.decode(errors='replace')}")
            continue
        os.replace(tmp, paths[name])
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (building all kernels first if
    this one is missing), with every entry point's signature declared."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            path = build()[name]
            lib = ctypes.CDLL(str(path))
            for fn, (argtypes, restype) in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = restype
            _libs[name] = lib
        return lib


def expect(op: str, t, name: str, dtype, shape) -> None:
    """Raise unless tensor ``t`` (argument ``name`` of kernel ``op``) is a
    contiguous CUDA tensor of ``dtype`` and ``shape``."""
    if t.device.type != "cuda":
        raise ValueError(f"{op}: {name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{op}: {name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{op}: {name} has shape {tuple(t.shape)}, want {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{op}: {name} must be contiguous")


def check(name: str, err: int) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {err}")

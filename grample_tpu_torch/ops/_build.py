"""Build the CUDA sources under ``grample_tpu_torch/csrc/`` with nvcc.

One shared library with a plain C interface, loaded with ctypes:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/libgrample_<hash>.so csrc/*.cu

The library lands in ``grample_tpu_torch/_build/`` (ignored by git),
built at first use and rebuilt when the sources' hash changes; what the
compiler printed (``-Xptxas -v``: registers, spills and shared memory of
every kernel instance) is kept beside it as ``.log``.  A failed build
raises; nothing falls back.

``load_host_library`` builds one host C++ source (no CUDA) with
``g++ -O2 -shared -fPIC`` into the same directory under the same
staleness rule.  It returns None where no compiler is found: its callers
(``grample_tpu_torch.native``) have portable Python paths, and no device
work is involved.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _sources() -> list:
    srcs = sorted(glob.glob(os.path.join(CSRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return srcs


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                           "are built from source at first use")
    return found


def library_path() -> str:
    """Path of the shared library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as fh:
            h.update(os.path.basename(src).encode() + fh.read())
    return os.path.join(BUILD_DIR, f"libgrample_{h.hexdigest()[:16]}.so")


HOST_FLAGS = ["-O2", "-shared", "-fPIC"]


def load_host_library(name: str):
    """Build ``csrc/<name>`` with g++ if its library is missing, then load
    it; None when no compiler is found or the build fails."""
    src = os.path.join(CSRC_DIR, name)
    with open(src, "rb") as fh:
        digest = hashlib.sha256(" ".join(HOST_FLAGS).encode() + fh.read()).hexdigest()[:16]
    path = os.path.join(BUILD_DIR, f"lib{os.path.splitext(name)[0]}_{digest}.so")
    if not os.path.exists(path):
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            return None
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            subprocess.run([cxx, *HOST_FLAGS, "-o", tmp, src], check=True,
                           capture_output=True, timeout=120)
        except (OSError, subprocess.SubprocessError):
            os.unlink(tmp)
            return None
        os.replace(tmp, path)
    return ctypes.CDLL(path)


def load_library() -> ctypes.CDLL:
    """Build the sources if their library is missing, then load it."""
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
                f"{proc.stdout}{proc.stderr}")
        with open(path + ".log", "w") as fh:
            fh.write(proc.stdout + proc.stderr)
        os.replace(tmp, path)  # atomic: a concurrent loader sees all or nothing
    return ctypes.CDLL(path)

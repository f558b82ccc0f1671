"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each kernel is one `.cu` file under `csrc/` with a plain C interface (no
PyTorch headers, so a build takes seconds).  A build is keyed by a hash of
the source text, the generated header (if any) and the flags; the shared
library lands in `build/` beside the package and is reused while the key
is unchanged.

`start_build` launches nvcc without waiting so several sources compile in
parallel; `finish_build` waits and loads the library.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Optional, Sequence

CSRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    # no a*b+c contraction: the kernels round like their plain PyTorch
    # versions (separate multiply and add), so the two are compared at the
    # f32 tolerances of the reference tests rather than at looser ones
    "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)


def build_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "dartenv_tpu_torch")
    os.makedirs(d, exist_ok=True)
    return d


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"),
                 "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of dartenv_tpu_torch are built "
        "from source at first use and need the CUDA toolkit")


@dataclasses.dataclass
class Build:
    tag: str
    so_path: str
    proc: Optional[subprocess.Popen]
    log_path: str


_LOADED: Dict[str, ctypes.CDLL] = {}


def _keyed_dir(tag, source, header_text, header_name, deps, flags):
    """(out_dir, src_path): the build directory keyed by a hash of the
    source, its csrc dependencies, the generated header and the flags;
    the header is written into it."""
    src_path = os.path.join(CSRC_DIR, source)
    h = hashlib.sha256()
    for name in (source, *deps):
        with open(os.path.join(CSRC_DIR, name), "rb") as f:
            h.update(f.read())
    h.update((header_text or "").encode())
    h.update(" ".join(flags).encode())
    out_dir = os.path.join(build_dir(), f"{tag}_{h.hexdigest()[:16]}")
    os.makedirs(out_dir, exist_ok=True)
    if header_text is not None:
        with open(os.path.join(out_dir, header_name), "w") as f:
            f.write(header_text)
    return out_dir, src_path


def start_build(tag: str, source: str, header_text: Optional[str] = None,
                header_name: str = "generated.h",
                deps: Sequence[str] = ()) -> Build:
    """Start compiling csrc/<source> with nvcc (an optional generated
    header and csrc/ are on its include path; `deps` are further csrc
    files the source includes).  Returns at once; an up-to-date library is
    reused."""
    out_dir, src_path = _keyed_dir(tag, source, header_text, header_name,
                                   deps, NVCC_FLAGS)
    so_path = os.path.join(out_dir, f"lib{tag}.so")
    log_path = os.path.join(out_dir, "nvcc.log")
    if so_path in _LOADED or os.path.exists(so_path):
        return Build(tag, so_path, None, log_path)
    tmp = so_path + f".tmp{os.getpid()}"
    cmd = [find_nvcc(), *NVCC_FLAGS, "-Xptxas", "-v",
           "-I", out_dir, "-I", CSRC_DIR, "-o", tmp, src_path]
    log = open(log_path, "w")
    proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
    proc._dartenv_tmp = tmp          # renamed into place by finish_build
    proc._dartenv_log = log
    return Build(tag, so_path, proc, log_path)


def finish_build(build: Build) -> ctypes.CDLL:
    """Wait for the compiler, raise with its output on failure, load."""
    if build.so_path in _LOADED:
        return _LOADED[build.so_path]
    if build.proc is not None:
        rc = build.proc.wait()
        build.proc._dartenv_log.close()
        if rc != 0:
            with open(build.log_path) as f:
                raise RuntimeError(
                    f"nvcc failed for {build.tag} (exit {rc}):\n{f.read()}")
        os.replace(build.proc._dartenv_tmp, build.so_path)
    lib = ctypes.CDLL(build.so_path)
    _LOADED[build.so_path] = lib
    return lib


HOST_FLAGS = ("-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC")


def build_host(tag: str, source: str, header_text: Optional[str] = None,
               header_name: str = "generated.h",
               deps: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile csrc/<source> with the host C++ compiler (no GPU code) and
    load it; same keying as start_build.  Used to run a kernel's per-env
    arithmetic on machines without a GPU, in tests only."""
    out_dir, src_path = _keyed_dir(tag, source, header_text, header_name,
                                   deps, HOST_FLAGS)
    so_path = os.path.join(out_dir, f"lib{tag}.so")
    if so_path not in _LOADED:
        if not os.path.exists(so_path):
            cxx = os.environ.get("CXX") or shutil.which("g++")
            if not cxx:
                raise RuntimeError("no host C++ compiler (g++) found")
            tmp = so_path + f".tmp{os.getpid()}"
            proc = subprocess.run(
                [cxx, *HOST_FLAGS, "-I", out_dir, "-I", CSRC_DIR, "-o", tmp,
                 src_path], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"{cxx} failed for {tag}:\n{proc.stderr}")
            os.replace(tmp, so_path)
        _LOADED[so_path] = ctypes.CDLL(so_path)
    return _LOADED[so_path]


def build_log(build: Build) -> str:
    """The compiler's output (register / spill report of -Xptxas -v)."""
    if os.path.exists(build.log_path):
        with open(build.log_path) as f:
            return f.read()
    return ""


def check_launch(code: int, what: str):
    """Raise if a launch wrapper returned a CUDA error code."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")

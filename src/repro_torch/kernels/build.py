"""Build CUDA sources with `nvcc` into shared libraries with a plain C
interface, loaded with `ctypes`.

A library is built at first use into `build/kernels/` at the root of the
checkout, under a name keyed by a hash of its source, the headers (`.cuh`)
beside it and the flags, so an edited source or header rebuilds and an
unchanged one is reused. Nothing is built when a module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Sequence

import torch

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass
class Build:
    """One built library: its path, what ptxas reported (registers,
    spills), and the seconds nvcc took (0 when it was reused)."""
    source: Path
    library: Path
    log: str
    seconds: float


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(source: Path) -> Path:
    """The library's path: keyed by the source, every header in its
    directory (a source includes them by relative path) and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(header.name.encode() + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{source.stem}-{h.hexdigest()[:12]}.so"


def build(sources: Sequence[Path]) -> List[Build]:
    """Compile every source not yet built, one `nvcc` per source, all
    started together. Raises with nvcc's output if any build fails."""
    if not torch.cuda.is_available():
        raise RuntimeError("CUDA kernels need a CUDA device; none is "
                           "available")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for src in sources:
        src = Path(src)
        out = _target(src)
        if out.exists():
            jobs.append((src, out, None, 0.0, ""))
            continue
        # build under a private name, then rename: concurrent builders of
        # the same source never load a half-written library
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                                 str(src)], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((src, out, proc, time.perf_counter(), str(tmp)))
    builds = []
    for src, out, proc, t0, tmp in jobs:
        if proc is None:
            builds.append(Build(src, out, "(reused)", 0.0))
            continue
        log, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        os.replace(tmp, out)
        builds.append(Build(src, out, log, time.perf_counter() - t0))
    return builds


def load(source: Path) -> ctypes.CDLL:
    """The library for `source`, built first if it is not built yet."""
    (b,) = build([Path(source)])
    return ctypes.CDLL(str(b.library))

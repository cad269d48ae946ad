"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles in its own ``nvcc`` process, all
started together, and the objects link into one shared library with a plain
C interface, loaded with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 \\
         -Xcompiler -fPIC -Xptxas -v --split-compile=0 [source flags] -c -o <obj> csrc/<source>.cu   # one per source
    nvcc -gencode arch=compute_90a,code=sm_90a -shared -o <build>/libfear_kernels_<hash>.so <objs>

The library is built at first use (never at import), only from the sources
in the checkout, and cached under ``feartracker_tpu_torch/_kernels_build/``
by a hash of the sources and flags; ``build.log`` there keeps the compiler's
output (ptxas registers, shared memory and spills per kernel). ``decode.cu``
and ``crop.cu`` build with ``-fmad=false`` (``SOURCE_FLAGS``): each plain twin
is a chain of torch ops, each rounded on its own, and a fused multiply-add
rounds once, which can move a frame box by a pixel at a .5 boundary or a
crop value by an ulp. ``--split-compile=0``
lets nvcc optimise and assemble a source's kernels on every core at once
(``ir_block.cu`` holds 16 kernel instances).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_kernels_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)

# flags of one source beside NVCC_FLAGS
SOURCE_FLAGS = {"decode.cu": ("-fmad=false",), "crop.cu": ("-fmad=false",)}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# C signatures of the exported entry points (see csrc/*.cu)
SIGNATURES = {
    "fear_decode": [_P, _P, _I] + [_L] * 7 + [_P] * 11 + [_I] * 4 + [_F] * 8 + [_P],
    "fear_crop": [_P, _I] + [_L] * 4 + [_P] * 3 + [_I] * 5 + [_F] * 6 + [_P],
    "fear_ir_block": [_P] * 8 + [_I] * 14 + [_P] * 3,
    "fear_ir_block_bf16": [_P] * 6 + [_I] * 14 + [_P],
    "fear_ir_block_smem_bytes": [_I] * 7,
    "fear_ir_block_occupancy": [_I] * 7,
    "fear_mark_launch": [_I, _P],
}


def sources():
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources():
        h.update(path.name.encode())
        h.update(" ".join(SOURCE_FLAGS.get(path.name, ())).encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    candidates = [shutil.which("nvcc")]
    if CUDA_HOME:
        candidates.append(os.path.join(CUDA_HOME, "bin", "nvcc"))
    for c in candidates:
        if c and os.path.exists(c):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit to build")


def build() -> Path:
    """Compile the library if no build of the current sources exists; return its path."""
    lib = BUILD_DIR / f"libfear_kernels_{source_hash()}.so"
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        cmds = [[nvcc, *NVCC_FLAGS, *SOURCE_FLAGS.get(src.name, ()), "-c", "-o", f"{tmp}/{src.stem}.o", str(src)]
                for src in sources() if src.suffix == ".cu"]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True) for cmd in cmds]
        outs = [p.communicate()[0] for p in procs]
        link = [nvcc, *NVCC_FLAGS[:2], "-shared", "-o", f"{tmp}/lib.so", *(cmd[cmd.index("-o") + 1] for cmd in cmds)]
        failed = [(" ".join(c), o) for c, o, p in zip(cmds, outs, procs) if p.returncode != 0]
        if not failed:
            proc = subprocess.run(link, capture_output=True, text=True)
            outs.append(proc.stdout + proc.stderr)
            if proc.returncode != 0:
                failed.append((" ".join(link), outs[-1]))
        (BUILD_DIR / "build.log").write_text(
            "".join(" ".join(c) + "\n" + o for c, o in zip(cmds + [link], outs)))
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"{c}\n{o[-4000:]}" for c, o in failed))
        os.replace(f"{tmp}/lib.so", lib)
    return lib


@functools.cache
def load_library() -> ctypes.CDLL:
    """The built kernel library, with ``argtypes``/``restype`` set."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")

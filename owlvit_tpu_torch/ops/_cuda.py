"""Build and bind the port's CUDA kernels.

Every ../csrc/*.cu is compiled by nvcc for sm_90a at first use into one
shared library with a plain C interface under ../_build/ (named by a hash of
the sources, the headers they share and the flags, reused while none of them
changes) and bound with
ctypes, so importing this module needs neither nvcc nor a card. Each C entry
point launches on the stream it is given, never synchronises, and returns
cudaGetLastError(); `launch` raises if that is not 0.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel dtype codes shared by every C entry point
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C entry point -> argument types (pointers and the stream as c_void_p, so
# that ctypes does not cut them to 32 bits)
_SIGNATURES = {
    # q k v o lse | B S H hd valid_len | scale softmax static_max dtype stream
    # (softmax: 0 per-row max, 1 fixed shift, 2 fast)
    "owlvit_pk_fwd": [_P] * 5 + [_I] * 5 + [_F, _I, _F, _I, _P],
    # q k v o lse do delta dq dk dv | B S H hd valid_len | scale dtype stream
    "owlvit_pk_bwd": [_P] * 10 + [_I] * 5 + [_F, _I, _P],
    # q k v o lse do delta dq ks | B S H hd valid_len | scale dtype stream
    "owlvit_pk_dq": [_P] * 9 + [_I] * 5 + [_F, _I, _P],
    # the bf16 dq kernel's dynamic shared memory in bytes (no launch, no stream)
    "owlvit_pk_dq_smem_bytes": [],
    # q k v lse do delta dk dv qs | B S H hd valid_len | scale dtype stream
    "owlvit_pk_dkv": [_P] * 9 + [_I] * 5 + [_F, _I, _P],
    # with q * scale tiles (0 or 1) -> the bf16 dkv kernel's dynamic shared
    # memory in bytes (no launch, no stream)
    "owlvit_pk_dkv_smem_bytes": [_I],
    # x h scale bias r y | N D | eps dtype stream
    "owlvit_add_ln_fwd": [_P] * 6 + [_I] * 2 + [_F, _I, _P],
    # r dy dr scale g part_scale part_bias dscale dbias | N D blocks | eps dtype stream
    "owlvit_add_ln_bwd": [_P] * 9 + [_I] * 3 + [_F, _I, _P],
    # D dtype device -> the backward kernel's resident blocks (no launch, no stream)
    "owlvit_add_ln_bwd_resident_blocks": [_I, _I, _I],
    # D dtype -> the backward kernel's dynamic shared memory in bytes (no launch)
    "owlvit_add_ln_bwd_smem_bytes": [_I, _I],
    # cost row_mask col4row | B R C | stream
    "owlvit_jv_assign": [_P] * 3 + [_I] * 3 + [_P],
    # boxes classes_in classes_out | B P background | threshold stream
    "owlvit_propagate_labels": [_P] * 3 + [_I] * 3 + [_F, _P],
}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_name(csrc: Path, flags: tuple) -> str:
    """The file name of the library built from the sources in `csrc` with
    `flags`: a hash of the flags and of every *.cu and *.cuh there, so that
    editing a shared header builds anew."""
    h = hashlib.sha256(" ".join(flags).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return f"libowlvit_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile csrc/*.cu with nvcc for sm_90a into one shared library under
    _build/, named by `library_name`; reuse it if present. One nvcc per
    source, all started together, then one link. nvcc's report (registers,
    shared memory, spills) goes beside it as .log."""
    srcs = sorted(CSRC.glob("*.cu"))
    flags = NVCC_FLAGS
    out = BUILD_DIR / library_name(CSRC, flags)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in srcs]
    procs = [subprocess.Popen([nvcc, *flags, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for src, obj in zip(srcs, objs)]
    logs, failed = [], False
    for src, proc in zip(srcs, procs):
        stdout, stderr = proc.communicate()
        logs.append(f"== {src.name}\n{stdout}{stderr}")
        failed |= proc.returncode != 0
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(logs))
        link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    out.with_suffix(".log").write_text("\n".join(logs))
    os.replace(tmp, out)  # atomic: a concurrent build sees all or nothing
    return out


def ptxas_report(lib_path: Path) -> dict:
    """nvcc -Xptxas -v's report of the build at `lib_path`, per entry
    function: {mangled name: [its stack and spills line, its registers line,
    and any note that its wgmma instructions are serialized]}. ptxas prints
    such a note before it compiles the function, so the note goes to the
    function it names (else to the entry function being compiled)."""
    out, current = {}, None
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            current = m.group(1)
            out.setdefault(current, [])
            continue
        text = re.sub(r"^ptxas (info|warning)\s*:\s*", "", line.strip())
        if wgmma_serialized([line]):
            named = re.search(r"function '([^']+)'", line)
            name = named.group(1) if named else current
            if name:
                out.setdefault(name, []).append(text)
        elif current and ("registers" in line or "spill" in line):
            out[current].append(text)
    return out


def wgmma_serialized(lines) -> bool:
    """Whether any of ptxas's `lines` says that wgmma instructions are
    serialized (the products then wait for each other)."""
    return any("wgmma" in line and "serialized" in line for line in lines)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library with every entry point's argument types set."""
    return bind(build())


def bind(path: Path) -> ctypes.CDLL:
    """Load the library at `path` and set every entry point's argument
    types. An entry point the library lacks (a build of older sources) is
    left unbound: calling it raises AttributeError."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in _SIGNATURES.items():
        if not hasattr(lib, name):
            continue
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point `name` with `args` and the current stream of
    `device` appended; raise if the launch was refused."""
    with torch.cuda.device(device):
        err = getattr(library(), name)(
            *args, torch.cuda.current_stream(device).cuda_stream)
    if err:
        raise RuntimeError(f"{name}: kernel launch failed: CUDA error {err}")


def query(name: str, device: torch.device, *args) -> int:
    """Call C entry point `name` (one that launches nothing) with `args` on
    `device` and return its result; raise if it is negative (minus a CUDA
    error)."""
    with torch.cuda.device(device):
        out = getattr(library(), name)(*args)
    if out < 0:
        raise RuntimeError(f"{name}: CUDA error {-out}")
    return out

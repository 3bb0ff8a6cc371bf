"""ctypes bindings for the C++ host kernels, with transparent build + fallback.

`lib()` returns the loaded shared library, compiling it with g++ on first use.
Callers treat `lib() is None` as "use the pure Python/NumPy path" — the
framework never hard-requires the native build.

The port's copy of owlvit_tpu/native (binding and sources; the C++ files
carry the originals' code unchanged). One change: the libraries are built into the
gitignored owlvit_tpu_torch/_build/, each g++ writing a file of its own that
is then renamed into place, so that processes building at once never load a
half-written library. These kernels run on the host (JV assignment, NMS, COCO
matching, JPEG/PNG decode and resize), never on the GPU.
tests/test_torch_data.py and tests/test_torch_map.py hold them equal to the
originals.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(__file__)
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_SRC = os.path.join(_DIR, "src", "owlvit_native.cpp")
_SO = os.path.join(_BUILD, "libowlvit_native.so")


def _compile(flags: list, out: str, inputs: list, timeout: int) -> bool:
    """g++ into a file of this process's own, renamed onto `out`."""
    os.makedirs(_BUILD, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
    os.close(fd)
    try:
        subprocess.run(["g++", *flags, "-o", tmp, *inputs], check=True,
                       capture_output=True, timeout=timeout)
        os.replace(tmp, out)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)

_lib = None
_tried = False


def build(force: bool = False) -> str | None:
    if os.path.exists(_SO) and not force:
        # a shipped .so WITHOUT the src tree is still usable (matches
        # build_image's contract; getmtime on the absent source raised
        # FileNotFoundError here and broke lib()'s "None -> Python
        # fallback" contract for every caller)
        if not os.path.exists(_SRC):
            return _SO
        if os.path.getmtime(_SO) >= os.path.getmtime(_SRC):
            return _SO
    if not os.path.exists(_SRC):
        return _SO if os.path.exists(_SO) else None
    if _compile(["-O3", "-shared", "-fPIC"], _SO, [_SRC], 120):
        return _SO
    return None


def lib():
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    so = build()
    if so is None:
        return None
    L = ctypes.CDLL(so)
    L.lsap_solve.restype = ctypes.c_int
    L.lsap_solve.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    L.nms.restype = ctypes.c_int
    L.nms.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    L.coco_match.restype = None
    L.coco_match.argtypes = [
        ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double),
        ctypes.c_int, ctypes.POINTER(ctypes.c_uint8),
        ctypes.POINTER(ctypes.c_uint8),
    ]
    _lib = L
    return _lib


def _ptr(a, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def lsap(cost: np.ndarray) -> np.ndarray | None:
    """Host linear sum assignment; [R, C] float -> col4row [R] int32."""
    L = lib()
    if L is None:
        return None
    cost = np.ascontiguousarray(cost, np.float64)
    out = np.empty((cost.shape[0],), np.int32)
    rc = L.lsap_solve(
        _ptr(cost, ctypes.c_double), cost.shape[0], cost.shape[1],
        _ptr(out, ctypes.c_int),
    )
    if rc != 0:
        raise ValueError(f"lsap_solve failed: {rc}")
    return out


def nms(boxes: np.ndarray, scores: np.ndarray, iou_thresh: float,
        max_out: int) -> np.ndarray | None:
    L = lib()
    if L is None:
        return None
    boxes = np.ascontiguousarray(boxes, np.float32)
    scores = np.ascontiguousarray(scores, np.float32)
    keep = np.empty((max_out,), np.int32)
    n = L.nms(
        _ptr(boxes, ctypes.c_float), _ptr(scores, ctypes.c_float),
        len(scores), iou_thresh, max_out, _ptr(keep, ctypes.c_int),
    )
    return keep[:n]


# ---------------------------------------------------------------- image pool

_IMG_SRC = os.path.join(_DIR, "src", "image_pool.cpp")
_IMG_SO = os.path.join(_BUILD, "libowlvit_image.so")
_img_lib = None
_img_tried = False


def build_image(force: bool = False) -> str | None:
    if os.path.exists(_IMG_SO) and not force:
        # a shipped .so without the src tree is still usable
        if not os.path.exists(_IMG_SRC):
            return _IMG_SO
        if os.path.getmtime(_IMG_SO) >= os.path.getmtime(_IMG_SRC):
            return _IMG_SO
    if not os.path.exists(_IMG_SRC):
        return None
    # -march=native is safe: the library is built on the host it runs on.
    if _compile(["-O3", "-march=native", "-shared", "-fPIC"], _IMG_SO,
                [_IMG_SRC, "-ljpeg", "-lpng", "-lz", "-lpthread"], 180):
        return _IMG_SO
    return None


def image_lib():
    global _img_lib, _img_tried
    if _img_lib is not None or _img_tried:
        return _img_lib
    _img_tried = True
    so = build_image()
    if so is None:
        return None
    try:
        L = ctypes.CDLL(so)
    except OSError:
        return None
    L.owlvit_decode_resize_batch.restype = ctypes.c_int
    L.owlvit_decode_resize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_int,
    ]
    L.owlvit_decode_bytes.restype = ctypes.c_int
    L.owlvit_decode_bytes.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_size_t,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ]
    L.owlvit_free_buffer.restype = None
    L.owlvit_free_buffer.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    _img_lib = L
    return _img_lib


def decode_resize_batch(
    paths: list, out_size: int, n_threads: int = 0
) -> tuple | None:
    """Threaded native decode (JPEG/PNG) + PIL-exact bicubic resize.

    -> (images [n, S, S, 3] uint8, wh [n, 2] int32, ok [n] bool) or None if
    the native library is unavailable. Failed slots have ok=False (caller
    falls back to PIL for those).
    """
    L = image_lib()
    if L is None:
        return None
    n = len(paths)
    out = np.empty((n, out_size, out_size, 3), np.uint8)
    wh = np.zeros((n, 2), np.int32)
    ok = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    L.owlvit_decode_resize_batch(
        arr, n, out_size, _ptr(out, ctypes.c_uint8), _ptr(wh, ctypes.c_int),
        _ptr(ok, ctypes.c_int), n_threads,
    )
    return out, wh, ok.astype(bool)


def decode_bytes(data: bytes) -> "np.ndarray | None":
    """Decode ONE in-memory JPEG/PNG -> [h, w, 3] uint8 (serving uploads).

    Releases the GIL inside libjpeg/libpng. Returns None when the native
    library is unavailable OR the payload needs the PIL fallback (16-bit
    PNGs, other formats) — callers keep a PIL path.
    """
    L = image_lib()
    if L is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    out = ctypes.POINTER(ctypes.c_uint8)()
    w = ctypes.c_int()
    h = ctypes.c_int()
    if not L.owlvit_decode_bytes(
        _ptr(buf, ctypes.c_uint8), buf.size, ctypes.byref(out),
        ctypes.byref(w), ctypes.byref(h),
    ):
        return None
    try:
        arr = np.ctypeslib.as_array(out, shape=(h.value, w.value, 3)).copy()
    finally:
        L.owlvit_free_buffer(out)
    return arr


def coco_match(iou: np.ndarray, gt_ignore: np.ndarray,
               thrs: np.ndarray) -> tuple | None:
    L = lib()
    if L is None:
        return None
    D, G = iou.shape
    T = len(thrs)
    iou = np.ascontiguousarray(iou, np.float64)
    gt_ignore = np.ascontiguousarray(gt_ignore, np.uint8)
    thrs = np.ascontiguousarray(thrs, np.float64)
    matched = np.zeros((T, D), np.uint8)
    ignored = np.zeros((T, D), np.uint8)
    L.coco_match(
        _ptr(iou, ctypes.c_double), D, G, _ptr(gt_ignore, ctypes.c_uint8),
        _ptr(thrs, ctypes.c_double), T,
        _ptr(matched, ctypes.c_uint8), _ptr(ignored, ctypes.c_uint8),
    )
    return matched.astype(bool), ignored.astype(bool)

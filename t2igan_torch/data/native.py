"""ctypes bindings of the port's host library: the image decoder, the
pyramid transform and the async data executor (the port's counterpart of
:mod:`t2igan.native`).

``csrc/image_ops.cc``, ``csrc/image_decode.cc`` and ``csrc/image_exec.cc``
build with ``g++ -O3 -fPIC -shared -std=c++17 -pthread ... -lz`` into one
library under ``t2igan_torch/_build/``, named by a hash of the sources, the
headers and the flags, at first use (never on import).  The compiler writes
to a temporary name that is then renamed into place, so processes that
build at once never load half a file.  It exposes:

* :func:`decode_image`: a JPEG or PNG file to uint8 RGB,
  PIL's ``Image.open(...).convert("RGB")`` pixels (the port's own decoder:
  the machine with the card has no PIL, libjpeg or libpng);
  :func:`image_dims`: height and width from the header alone;
* :func:`resize_rgb`, :func:`pyramid`, :func:`pyramid_batch`: the JAX
  package's triangle-filter resize and per-sample pyramid;
* :func:`resize_pil_bilinear`, :func:`resize_pil_bicubic`: PIL's
  ``Image.resize(..., BILINEAR)`` and ``Image.resize(...)`` (BICUBIC);
* :func:`load_sample`: read, decode, bbox crop and pyramid of one sample;
* :class:`AsyncExecutor`: the C++ thread pool with a ring of batch slots.

What the decoder refuses (corrupt or truncated files, and the formats and
features it does not decode) raises :class:`DecodeError` naming the file
and the fault; nothing falls back to another decoder.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

from t2igan_torch.ops.image import CLIP_MEAN, CLIP_STD

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCES = ("image_ops.cc", "image_decode.cc", "image_exec.cc")
HEADERS = ("image_core.h", "image_decode.h")
GXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
LIBS = ("-lz",)

# Per-sample error codes (csrc/image_decode.h, the JAX package's EXEC_ERR_*).
EXEC_ERR_READ = 1
EXEC_ERR_DECODE = 2
EXEC_ERR_CROP = 4

_MEAN = np.asarray(CLIP_MEAN, np.float32)
_STD = np.asarray(CLIP_STD, np.float32)
_ERRLEN = 1024

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class DecodeError(ValueError):
    """An image the port cannot read: missing, corrupt, truncated, or of a
    format or feature its decoder does not take."""


def library_path() -> Path:
    """Where the host library builds to, keyed by its sources and flags."""
    h = hashlib.sha256(" ".join(GXX_FLAGS + LIBS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    return BUILD_DIR / f"libt2igan_host-{h.hexdigest()[:16]}.so"


def build() -> float:
    """Compile the host library unless it is built; returns the seconds the
    compile took (0.0 when it was there).  Raises with the compiler's
    output when it fails."""
    out = library_path()
    if out.exists():
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = ["g++", *GXX_FLAGS, *(str(CSRC_DIR / s) for s in SOURCES),
           "-o", str(tmp), *LIBS]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"building the host library failed:\n"
                           f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded host library, built at the first call."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        build()
        lib = ctypes.CDLL(str(library_path()))
        u8p = ctypes.POINTER(ctypes.c_uint8)
        f32p = ctypes.POINTER(ctypes.c_float)
        i32p = ctypes.POINTER(ctypes.c_int)
        c_int, c_char_p, c_void_p = ctypes.c_int, ctypes.c_char_p, \
            ctypes.c_void_p
        sigs = {
            "t2i_resize_rgb": ([u8p, c_int, c_int, f32p, c_int, c_int],
                               None),
            "t2i_resize_pil_bilinear": ([u8p, c_int, c_int, u8p, c_int,
                                         c_int], None),
            "t2i_resize_pil_bicubic": ([u8p, c_int, c_int, u8p, c_int,
                                        c_int], None),
            "t2i_pyramid": ([u8p, c_int, c_int, c_int, c_int, c_int, c_int,
                             c_int, i32p, c_int, ctypes.POINTER(f32p), f32p,
                             f32p], c_int),
            "t2i_pyramid_batch": ([ctypes.POINTER(u8p), i32p, i32p, c_int,
                                   c_int, i32p, i32p, i32p, i32p, c_int,
                                   ctypes.POINTER(f32p), f32p, f32p, c_int,
                                   c_int], c_int),
            "t2i_decode_file": ([c_char_p, ctypes.POINTER(u8p), i32p, i32p,
                                 c_char_p, c_int], c_int),
            "t2i_free": ([c_void_p], None),
            "t2i_image_dims": ([c_char_p, i32p, i32p, c_char_p, c_int],
                               c_int),
            "t2i_load_sample": ([c_char_p, i32p, c_int, c_int, c_int, c_int,
                                 c_int, i32p, c_int, ctypes.POINTER(f32p),
                                 f32p, f32p, c_char_p, c_int], c_int),
            "t2i_exec_create": ([c_int, c_int, c_int, i32p, c_int, c_int,
                                 c_int, f32p, f32p], c_void_p),
            "t2i_exec_submit": ([c_void_p, c_int, c_int,
                                 ctypes.POINTER(c_char_p), i32p, f32p, u8p],
                                c_int),
            "t2i_exec_inflight": ([c_void_p], c_int),
            "t2i_exec_wait": ([c_void_p, i32p, i32p, ctypes.POINTER(f32p),
                               i32p], c_int),
            "t2i_exec_message": ([c_void_p, c_int, c_int, c_char_p, c_int],
                                 c_int),
            "t2i_exec_release": ([c_void_p, c_int], c_int),
            "t2i_exec_destroy": ([c_void_p], None),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = args
            fn.restype = res
        _lib = lib
        return _lib


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def _fail(code: int, err, default: str):
    msg = err.value.decode(errors="replace") or default
    raise DecodeError(f"{msg} (error code {code})")


def _take_rgb(lib, buf, h: int, w: int) -> np.ndarray:
    try:
        data = ctypes.cast(buf, ctypes.POINTER(ctypes.c_uint8 * (h * w * 3)))
        return np.frombuffer(data.contents, np.uint8).reshape(h, w, 3).copy()
    finally:
        lib.t2i_free(buf)


def decode_image(path: str) -> np.ndarray:
    """The image file at ``path`` as [H, W, 3] uint8 RGB."""
    lib = load()
    buf = ctypes.POINTER(ctypes.c_uint8)()
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.t2i_decode_file(os.fsencode(path), ctypes.byref(buf),
                             ctypes.byref(h), ctypes.byref(w), err, _ERRLEN)
    if rc:
        _fail(rc, err, path)
    return _take_rgb(lib, buf, h.value, w.value)


def image_dims(path: str) -> Tuple[int, int]:
    """(height, width) of the image file at ``path``, from its header."""
    lib = load()
    h, w = ctypes.c_int(), ctypes.c_int()
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.t2i_image_dims(os.fsencode(path), ctypes.byref(h),
                            ctypes.byref(w), err, _ERRLEN)
    if rc:
        _fail(rc, err, path)
    return h.value, w.value


def resize_rgb(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """Antialiased triangle-filter resize of HWC uint8 RGB -> float32 HWC in
    [0, 255]."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    out = np.empty((out_h, out_w, 3), np.float32)
    lib.t2i_resize_rgb(_u8p(img), img.shape[0], img.shape[1], _f32p(out),
                       out_h, out_w)
    return out


def _resize_pil(name: str, img: np.ndarray, out_h: int,
                out_w: int) -> np.ndarray:
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or out_h < 1 or out_w < 1:
        raise ValueError(f"{name}: bad shapes {img.shape} -> "
                         f"{(out_h, out_w)}")
    out = np.empty((out_h, out_w, 3), np.uint8)
    getattr(lib, f"t2i_{name}")(_u8p(img), img.shape[0], img.shape[1],
                                _u8p(out), out_h, out_w)
    return out


def resize_pil_bilinear(img: np.ndarray, out_h: int,
                        out_w: int) -> np.ndarray:
    """PIL's ``Image.resize((out_w, out_h), BILINEAR)`` of HWC uint8 RGB,
    bit for bit."""
    return _resize_pil("resize_pil_bilinear", img, out_h, out_w)


def resize_pil_bicubic(img: np.ndarray, out_h: int,
                       out_w: int) -> np.ndarray:
    """PIL's ``Image.resize((out_w, out_h))`` of HWC uint8 RGB: its
    default filter for RGB, BICUBIC (cubic convolution, a = -0.5), bit for
    bit."""
    return _resize_pil("resize_pil_bicubic", img, out_h, out_w)


def _branch_outputs(branch_sizes: Sequence[int]):
    outs = [np.empty((s, s, 3), np.float32) for s in branch_sizes]
    ptrs = (ctypes.POINTER(ctypes.c_float) * len(outs))(
        *[_f32p(o) for o in outs])
    return outs, ptrs


def pyramid(img: np.ndarray, scale_size: int, crop: int, crop_x: int,
            crop_y: int, flip: bool,
            branch_sizes: Sequence[int]) -> List[np.ndarray]:
    """Full per-sample pipeline -> list of CLIP-normalised float32 HWC."""
    lib = load()
    img = np.ascontiguousarray(img, np.uint8)
    sizes = np.asarray(branch_sizes, np.int32)
    outs, ptrs = _branch_outputs(branch_sizes)
    err = lib.t2i_pyramid(_u8p(img), img.shape[0], img.shape[1], scale_size,
                          crop, crop_x, crop_y, int(flip), _i32p(sizes),
                          len(outs), ptrs, _f32p(_MEAN), _f32p(_STD))
    if err:
        raise ValueError("t2i_pyramid: invalid crop window")
    return outs


def pyramid_batch(imgs: Sequence[np.ndarray], scale_size: int, crop: int,
                  crop_xy: Sequence[Sequence[int]], flips: Sequence[bool],
                  branch_sizes: Sequence[int],
                  n_threads: int = 4) -> List[List[np.ndarray]]:
    """Batched :func:`pyramid`, parallel across samples."""
    lib = load()
    n = len(imgs)
    imgs = [np.ascontiguousarray(im, np.uint8) for im in imgs]
    heights = np.asarray([im.shape[0] for im in imgs], np.int32)
    widths = np.asarray([im.shape[1] for im in imgs], np.int32)
    xs = np.asarray([c[0] for c in crop_xy], np.int32)
    ys = np.asarray([c[1] for c in crop_xy], np.int32)
    fl = np.asarray([int(f) for f in flips], np.int32)
    sizes = np.asarray(branch_sizes, np.int32)
    outs = [[np.empty((s, s, 3), np.float32) for s in branch_sizes]
            for _ in range(n)]
    src_ptrs = (ctypes.POINTER(ctypes.c_uint8) * n)(*[_u8p(i) for i in imgs])
    flat = [o for row in outs for o in row]
    out_ptrs = (ctypes.POINTER(ctypes.c_float) * len(flat))(
        *[_f32p(o) for o in flat])
    err = lib.t2i_pyramid_batch(src_ptrs, _i32p(heights), _i32p(widths),
                                scale_size, crop, _i32p(xs), _i32p(ys),
                                _i32p(fl), _i32p(sizes), len(branch_sizes),
                                out_ptrs, _f32p(_MEAN), _f32p(_STD), n,
                                n_threads)
    if err:
        raise ValueError("t2i_pyramid_batch: invalid crop window")
    return outs


def _bbox_array(bbox: Optional[Sequence[int]]) -> np.ndarray:
    bb = np.full(4, -1, np.int32)
    if bbox is not None:
        bb[:] = np.asarray(bbox, np.int32)
    return bb


def load_sample(path: str, bbox: Optional[Sequence[int]], scale_size: int,
                crop: int, crop_x: int, crop_y: int, flip: bool,
                branch_sizes: Sequence[int],
                out: Optional[Sequence[np.ndarray]] = None
                ) -> List[np.ndarray]:
    """Read, decode, crop to the CUB ``bbox`` ([x, y, w, h] or None) and
    build the pyramid at the crop (``crop_x``, ``crop_y``): one call, with
    the interpreter lock released.  ``out`` (one C-contiguous float32
    [s, s, 3] array per branch) receives the pyramid when given."""
    lib = load()
    bb = _bbox_array(bbox)
    sizes = np.asarray(branch_sizes, np.int32)
    if out is None:
        outs, ptrs = _branch_outputs(branch_sizes)
    else:
        outs = list(out)
        for o, s in zip(outs, branch_sizes):
            if (o.shape != (s, s, 3) or o.dtype != np.float32
                    or not o.flags.c_contiguous):
                raise ValueError(f"load_sample: output {o.shape} "
                                 f"{o.dtype} for branch {s}")
        ptrs = (ctypes.POINTER(ctypes.c_float) * len(outs))(
            *[_f32p(o) for o in outs])
    err = ctypes.create_string_buffer(_ERRLEN)
    rc = lib.t2i_load_sample(os.fsencode(path), _i32p(bb), scale_size, crop,
                             crop_x, crop_y, int(flip), _i32p(sizes),
                             len(outs), ptrs, _f32p(_MEAN), _f32p(_STD), err,
                             _ERRLEN)
    if rc:
        _fail(rc, err, path)
    return outs


class AsyncExecutor:
    """The C++ thread pool with a ring of batch slots (the JAX package's
    ``AsyncExecutor``): submit per-batch plans (paths, optional CUB bbox,
    crop fractions in [0, 1), flip bits) and block only on the oldest
    batch in flight; read, decode, bbox crop, scale/crop/flip and the
    CLIP-normalised pyramid run off the Python thread.  ``wait`` returns
    zero-copy views into the slot, valid until ``release(batch_id)``."""

    def __init__(self, branch_sizes: Sequence[int], scale_size: int,
                 crop: int, max_batch: int, n_threads: int = 4,
                 n_slots: int = 3):
        lib = load()
        self._lib = lib
        self.branch_sizes = [int(s) for s in branch_sizes]
        self.max_batch = int(max_batch)
        sizes = np.asarray(self.branch_sizes, np.int32)
        self._h = lib.t2i_exec_create(
            int(n_threads), int(n_slots), self.max_batch, _i32p(sizes),
            len(self.branch_sizes), int(scale_size), int(crop),
            _f32p(_MEAN), _f32p(_STD))
        if not self._h:
            raise RuntimeError("t2i_exec_create failed")

    def submit(self, batch_id: int, paths: Sequence[str],
               bboxes: Optional[Sequence[Optional[Sequence[int]]]],
               uv: np.ndarray, flips: Sequence[bool]) -> None:
        """Queue one batch plan; blocks only while every slot is in
        flight."""
        n = len(paths)
        if not 1 <= n <= self.max_batch:
            raise ValueError(f"batch of {n}, the executor takes 1.."
                             f"{self.max_batch}")
        cpaths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
        bb = np.stack([_bbox_array(b) for b in (bboxes or [None] * n)])
        uv = np.ascontiguousarray(uv, np.float32).reshape(n, 2)
        fl = np.asarray([int(f) for f in flips], np.uint8)
        rc = self._lib.t2i_exec_submit(self._h, int(batch_id), n, cpaths,
                                       _i32p(bb), _f32p(uv), _u8p(fl))
        if rc != 0:
            raise RuntimeError(f"t2i_exec_submit rc={rc}")

    def inflight(self) -> int:
        return self._lib.t2i_exec_inflight(self._h)

    def wait(self):
        """Block for the oldest submitted batch: ``(batch_id, branches,
        sample_err)``, the branches zero-copy ``[n, s, s, 3]`` float32 views
        (valid until ``release``), ``sample_err`` int32 ``[n]`` of EXEC_ERR_*
        codes (0 = ok; failed samples are zero-filled)."""
        bid, n = ctypes.c_int(), ctypes.c_int()
        ptrs = (ctypes.POINTER(ctypes.c_float) * len(self.branch_sizes))()
        errs = np.zeros(self.max_batch, np.int32)
        rc = self._lib.t2i_exec_wait(self._h, ctypes.byref(bid),
                                     ctypes.byref(n), ptrs, _i32p(errs))
        if rc != 0:
            raise RuntimeError("t2i_exec_wait: nothing in flight")
        branches = []
        for b, s in enumerate(self.branch_sizes):
            arr = np.ctypeslib.as_array(ptrs[b], shape=(n.value * s * s * 3,))
            branches.append(arr.reshape(n.value, s, s, 3))
        return bid.value, branches, errs[:n.value].copy()

    def message(self, batch_id: int, i: int) -> str:
        """The fault of sample ``i`` of the batch held since ``wait``."""
        buf = ctypes.create_string_buffer(_ERRLEN)
        if self._lib.t2i_exec_message(self._h, int(batch_id), int(i), buf,
                                      _ERRLEN):
            raise RuntimeError(f"t2i_exec_message: no sample {i} in batch "
                               f"{batch_id}")
        return buf.value.decode(errors="replace")

    def raise_errors(self, batch_id: int, errs: np.ndarray) -> None:
        """Raise :class:`DecodeError` for the first failed sample of the
        batch held since ``wait``, with its file, fault and code."""
        bad = np.nonzero(errs)[0]
        if len(bad):
            i = int(bad[0])
            raise DecodeError(f"{self.message(batch_id, i)} (error code "
                              f"{int(errs[i])}; {len(bad)} of {len(errs)} "
                              "samples of the batch failed)")

    def release(self, batch_id: int) -> None:
        rc = self._lib.t2i_exec_release(self._h, int(batch_id))
        if rc != 0:
            raise RuntimeError(f"t2i_exec_release: unknown batch {batch_id}")

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.t2i_exec_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

"""ctypes bindings of the host frame-ops library (port of
``stif_tpu/data/native.py``).

``csrc/frame_ops.cpp`` (a plain C ABI, its loops split over
``std::thread``s) is built with ``g++`` at first use into
``stif_tpu_torch/_build/`` by ``ops.cuda_build.load_host``.
The JAX module falls back to NumPy when its library is not built; here the
library is built instead, and a failed build raises with the compiler's
output. The plain version of ``host_imresize`` is
``data.datasets.host_imresize`` (the port's ``ops.resize.imresize`` on CPU
tensors): the tests hold one against the other.
"""

from __future__ import annotations

import ctypes
import math
import os
import shutil

import numpy as np

from stif_tpu_torch.ops import cuda_build

_F32 = ctypes.POINTER(ctypes.c_float)
_U8 = ctypes.POINTER(ctypes.c_uint8)


def _lib() -> ctypes.CDLL:
    lib = cuda_build.load_host("frame_ops")
    if lib.stif_imresize_f32.argtypes is None:
        lib.stif_imresize_f32.argtypes = [
            _F32, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_double,
            _F32]
        lib.stif_bgr_u8_to_rgb_f32.argtypes = [_U8, ctypes.c_int, _F32]
        lib.stif_degrade_u8.argtypes = [
            _U8, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_double, _F32]
        for fn in (lib.stif_imresize_f32, lib.stif_bgr_u8_to_rgb_f32,
                   lib.stif_degrade_u8):
            fn.restype = None
        lib.stif_num_threads.argtypes = []
        lib.stif_num_threads.restype = ctypes.c_int
    return lib


def num_threads() -> int:
    """Threads the library's loops run on: ``OMP_NUM_THREADS`` when set,
    else the host's hardware threads."""
    return int(_lib().stif_num_threads())


def available() -> bool:
    """Whether the library is built, or a compiler is there to build it."""
    return (cuda_build.host_library_path("frame_ops").exists()
            or bool(os.environ.get("CXX") or shutil.which("g++")))


def imresize_native(img: np.ndarray, scale: float) -> np.ndarray:
    """MATLAB bicubic resize (antialiased when shrinking) of a (H, W, C)
    float32 image to (ceil(H * scale), ceil(W * scale), C)."""
    img = np.ascontiguousarray(img, dtype=np.float32)
    if img.ndim != 3 or min(img.shape) < 1:
        raise ValueError(f"imresize_native: (H, W, C) image, got {img.shape}")
    h, w, c = img.shape
    out = np.empty((math.ceil(h * scale), math.ceil(w * scale), c),
                   np.float32)
    _lib().stif_imresize_f32(img.ctypes.data_as(_F32), h, w, c,
                             float(scale), out.ctypes.data_as(_F32))
    return out


def bgr_u8_to_rgb(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR -> float32 RGB in [0, 1]."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"bgr_u8_to_rgb: (H, W, 3) image, got {img.shape}")
    out = np.empty(img.shape, np.float32)
    _lib().stif_bgr_u8_to_rgb_f32(img.ctypes.data_as(_U8),
                                  img.shape[0] * img.shape[1],
                                  out.ctypes.data_as(_F32))
    return out


def degrade_u8(img: np.ndarray, y0: int, x0: int, crop: int,
               scale: float) -> np.ndarray:
    """Crop ``crop`` x ``crop`` at (y0, x0) of a uint8 BGR frame, convert
    to float32 RGB and MATLAB-bicubic resize by ``scale``, in one call."""
    img = np.ascontiguousarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"degrade_u8: (H, W, 3) image, got {img.shape}")
    h, w = img.shape[:2]
    if not (0 <= y0 and 0 <= x0 and crop > 0 and y0 + crop <= h
            and x0 + crop <= w):
        raise ValueError(f"degrade_u8: crop {crop} at ({y0}, {x0}) outside "
                         f"a {h}x{w} frame")
    n = math.ceil(crop * scale)
    out = np.empty((n, n, 3), np.float32)
    _lib().stif_degrade_u8(img.ctypes.data_as(_U8), h, w, int(y0), int(x0),
                           int(crop), float(scale), out.ctypes.data_as(_F32))
    return out


def host_imresize(img: np.ndarray, scale: float) -> np.ndarray:
    """MATLAB bicubic resize of (..., H, W, C) on the host by the native
    library (multithreaded); never touches the GPU."""
    img = np.asarray(img, np.float32)
    if img.ndim == 3:
        return imresize_native(img, scale)
    flat = img.reshape((-1,) + img.shape[-3:])
    outs = [imresize_native(f, scale) for f in flat]
    return np.stack(outs).reshape(img.shape[:-3] + outs[0].shape)

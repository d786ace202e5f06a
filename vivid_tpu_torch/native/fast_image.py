"""ctypes binding of the host-side image library, compiled at first use.

Counterpart of vivid_tpu/native/fast_image.py, on a copy of its C source
(`fast_image.c`), so that the two packages resize and decode a frame to the
same bits. `cc` builds the library into `build/native/<hash>/` at the
repository root, keyed by the source, and a failed build raises: PIL's
resize differs from this one by up to a level, so nothing falls back to it
silently. `VIVID_NO_NATIVE=1` keeps its JAX meaning and selects the PIL and
numpy paths on purpose.

  resize_bilinear_u8(img, size)  uint8 [H, W, 3] -> float32 [size, size, 3],
                                 PIL BILINEAR's filter (support widened on a
                                 downscale), computed in double precision
  resize_box_u8(img, f)          the exact f x f area mean, float32
  probe_dims(path)               (height, width) from a PNG's header alone
  load_rgb(path)                 uint8 [H, W, 3]; PIL for what the decoder
                                 does not take (JPEG, 16-bit, interlaced PNG)
  fast_resize_available(), png_decode_available()
                                 whether the library is in use (built and
                                 loaded, and not switched off)
"""

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().with_name("fast_image.c")
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
_U8P = ctypes.POINTER(ctypes.c_uint8)


def native_disabled() -> bool:
    return bool(os.environ.get("VIVID_NO_NATIVE"))


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built library (built now if no cached one matches the source)."""
    src = _SRC.read_bytes()
    out_dir = BUILD_DIR / hashlib.sha256(src).hexdigest()[:16]
    lib_path = out_dir / "libfast_image.so"
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f"libfast_image.so.{os.getpid()}.tmp"
        cmd = [os.environ.get("CC", "cc"), "-O3", "-fPIC", "-shared", str(_SRC),
               "-o", str(tmp), "-lz"]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {_SRC.name} failed ({' '.join(cmd)}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)   # atomic: concurrent builders each land a whole file
    lib = ctypes.CDLL(str(lib_path))
    lib.resize_bilinear_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int,
                                       ctypes.POINTER(ctypes.c_float), ctypes.c_int]
    lib.resize_bilinear_u8.restype = None
    lib.resize_box_u8.argtypes = [_U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                  ctypes.POINTER(ctypes.c_float)]
    lib.resize_box_u8.restype = None
    lib.png_dims.argtypes = [_U8P, ctypes.c_long, ctypes.POINTER(ctypes.c_int),
                             ctypes.POINTER(ctypes.c_int)]
    lib.png_dims.restype = ctypes.c_int
    lib.decode_png_rgb.argtypes = [_U8P, ctypes.c_long, _U8P]
    lib.decode_png_rgb.restype = ctypes.c_int
    return lib


def _available() -> bool:
    if native_disabled():
        return False
    try:
        library()
    except (OSError, RuntimeError):
        return False
    return True


def fast_resize_available() -> bool:
    return _available()


def png_decode_available() -> bool:
    return _available()


def _ptr(arr, ctype=ctypes.c_uint8):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def _rgb_u8(img) -> np.ndarray:
    """A C-contiguous uint8 [H, W, 3] copy or view of `img`; ValueError
    for any other shape (the C code reads three channels a pixel)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3 or 0 in img.shape:
        raise ValueError(f"expected an RGB image [H, W, 3], got {img.shape}")
    return img


def _png_dims(lib, buf: np.ndarray):
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.png_dims(_ptr(buf), ctypes.c_long(buf.size), ctypes.byref(w), ctypes.byref(h))
    return rc, h.value, w.value


def decode_png_rgb(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] (8-bit, non-interlaced gray, RGB,
    palette, gray + alpha, RGBA). ValueError on anything else."""
    lib = library()
    buf = np.frombuffer(data, np.uint8)
    rc, h, w = _png_dims(lib, buf)
    if rc != 0:
        raise ValueError(f"unsupported PNG (code {rc})")
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.decode_png_rgb(_ptr(buf), ctypes.c_long(buf.size), _ptr(out))
    if rc != 0:
        raise ValueError(f"PNG decode failed (code {rc})")
    return out


def probe_dims(path: str):
    """(height, width) of an image file without decoding its pixels: a PNG's
    33-byte header, else PIL's lazy open (which also reads the header only)."""
    if not native_disabled() and path.lower().endswith(".png"):
        with open(path, "rb") as f:
            head = np.frombuffer(f.read(64), np.uint8)
        rc, h, w = _png_dims(library(), head)
        if rc == 0:
            return h, w
    import PIL.Image
    with PIL.Image.open(path) as im:
        return im.height, im.width


def load_rgb(path: str) -> np.ndarray:
    """An image file as uint8 [H, W, 3] RGB: the native decoder for the PNGs
    it takes, PIL for everything else."""
    if not native_disabled() and path.lower().endswith(".png"):
        with open(path, "rb") as f:
            data = f.read()
        try:
            return decode_png_rgb(data)
        except ValueError:
            pass
    import PIL.Image
    return np.asarray(PIL.Image.open(path).convert("RGB"))


def resize_box_u8(img: np.ndarray, factor: int) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [H/f, W/f, 3], each f x f block's mean
    (numpy's reshape + mean in float32, bit for bit)."""
    img = _rgb_u8(img)
    h, w = img.shape[:2]
    if factor < 1 or h % factor or w % factor:
        raise ValueError(f"{img.shape} does not divide by {factor}")
    out = np.empty((h // factor, w // factor, 3), np.float32)
    library().resize_box_u8(_ptr(img), h, w, factor, _ptr(out, ctypes.c_float))
    return out


def resize_bilinear_u8(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] -> float32 [size, size, 3] in [0, 255]."""
    img = _rgb_u8(img)
    if size < 1:
        raise ValueError(f"size {size}")
    h, w = img.shape[:2]
    out = np.empty((size, size, 3), np.float32)
    library().resize_bilinear_u8(_ptr(img), h, w, _ptr(out, ctypes.c_float), size)
    return out

"""Every image codec call of the port: decode, encode, resize, colormap.

All of them go to OpenCV (cv2), imported inside the function that needs it, so that the
rest of the package (arrays in, arrays out) needs numpy and torch only. A missing cv2
raises ImportError naming it; no other library stands in, since another decoder or
resampler would give other pixels without saying so.

Images are (H, W, 3) uint8 in OpenCV's BGR channel order, as the reference reads them.
"""

from __future__ import annotations

import os

import numpy as np


def _cv2(what: str):
    # OpenCV reads EXR only with this switch, and looks at it when the codec is first
    # used, which may be long after the import: set it before every import of cv2 here
    os.environ.setdefault("OPENCV_IO_ENABLE_OPENEXR", "1")
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            f"atvsnet_torch.data.image_io.{what} needs OpenCV (the cv2 module), which is "
            "not installed; in-memory frames of a bucket's size need no codec"
        ) from e
    return cv2


def imread(path: str) -> np.ndarray:
    """Decode an image file to (H, W, 3) uint8 BGR; a missing or unreadable file raises."""
    img = _cv2("imread").imread(path)
    if img is None:  # cv2.imread returns None instead of raising
        raise FileNotFoundError(f"could not read image: {path}")
    return img


def imread_depth(path: str) -> np.ndarray:
    """Decode a float depth image (EXR) to (H, W) float32: its first channel. A file that
    is missing or cannot be decoded raises IOError naming the path."""
    cv2 = _cv2("imread_depth")
    try:
        img = cv2.imread(path, cv2.IMREAD_ANYDEPTH | cv2.IMREAD_ANYCOLOR)
    except cv2.error as e:
        raise IOError(f"could not decode depth map {path!r}: {e}") from e
    if img is None:
        raise IOError(f"could not decode depth map {path!r} (cv2.imread returned None)")
    img = np.asarray(img)
    if img.ndim == 3:
        img = img[..., 0]
    return img.astype(np.float32)


def imwrite(path: str, image: np.ndarray, jpeg_quality: int | None = None) -> None:
    """Encode a (H, W[, 3]) uint8 BGR image; the extension picks the format."""
    cv2 = _cv2("imwrite")
    params = [] if jpeg_quality is None else [int(cv2.IMWRITE_JPEG_QUALITY), int(jpeg_quality)]
    if not cv2.imwrite(path, image, params):
        raise OSError(f"could not write image: {path}")


def resize(image: np.ndarray, scale: float, interpolation: str = "linear") -> np.ndarray:
    """cv2.resize by one factor for both axes; "linear" or "nearest"."""
    cv2 = _cv2("resize")
    inter = cv2.INTER_LINEAR if interpolation == "linear" else cv2.INTER_NEAREST
    return cv2.resize(image, None, fx=scale, fy=scale, interpolation=inter)


def resize_to(image: np.ndarray, width: int, height: int,
              interpolation: str = "linear") -> np.ndarray:
    """cv2.resize to an exact (width, height); "linear" or "nearest"."""
    cv2 = _cv2("resize_to")
    inter = cv2.INTER_LINEAR if interpolation == "linear" else cv2.INTER_NEAREST
    return cv2.resize(image, (width, height), interpolation=inter)


def colormap(img: np.ndarray) -> np.ndarray:
    """Viridis rendering of a 2D map, scaled to its own min..max: (H, W, 3) uint8 BGR."""
    cv2 = _cv2("colormap")
    lo, hi = np.nanmin(img), np.nanmax(img)
    u8 = np.uint8(255 * (img - lo) / max(hi - lo, 1e-9))
    return cv2.applyColorMap(u8, cv2.COLORMAP_VIRIDIS)

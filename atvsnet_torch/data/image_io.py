"""Every image codec call of the port: decode, encode, resize, colormap.

All four go to OpenCV (cv2), imported inside the function that needs it, so that the
rest of the package (arrays in, arrays out) needs numpy and torch only. A missing cv2
raises ImportError naming it; no other library stands in, since another decoder or
resampler would give other pixels without saying so.

Images are (H, W, 3) uint8 in OpenCV's BGR channel order, as the reference reads them.
"""

from __future__ import annotations

import numpy as np


def _cv2(what: str):
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


def imwrite(path: str, image: np.ndarray) -> None:
    """Encode a (H, W[, 3]) uint8 BGR image; the extension picks the format."""
    if not _cv2("imwrite").imwrite(path, image):
        raise OSError(f"could not write image: {path}")


def resize(image: np.ndarray, scale: float, interpolation: str = "linear") -> np.ndarray:
    """cv2.resize by one factor for both axes; "linear" or "nearest"."""
    cv2 = _cv2("resize")
    inter = cv2.INTER_LINEAR if interpolation == "linear" else cv2.INTER_NEAREST
    return cv2.resize(image, None, fx=scale, fy=scale, interpolation=inter)


def colormap(img: np.ndarray) -> np.ndarray:
    """Viridis rendering of a 2D map, scaled to its own min..max: (H, W, 3) uint8 BGR."""
    cv2 = _cv2("colormap")
    lo, hi = np.nanmin(img), np.nanmax(img)
    u8 = np.uint8(255 * (img - lo) / max(hi - lo, 1e-9))
    return cv2.applyColorMap(u8, cv2.COLORMAP_VIRIDIS)

"""Photometric training augmentation (reference preprocess_colmap.py:346-393); the port of
atvsnet_tpu/data/augment.py, numpy only.

Gamma / brightness / per-pixel colour-shift jitter applied identically across a view
group (all views of one MVS sample must stay photometrically consistent), followed by
per-image variance normalization. The draws from the RandomState are the JAX package's,
in the same order, so a seeded run augments the same way in both.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from atvsnet_torch.data.preprocess import center_image


def augment_image_color(
    image: np.ndarray,
    random_gamma: float = 1.0,
    random_brightness: float = 1.0,
    random_color_image=0.0,
    normalize_image: bool = True,
) -> np.ndarray:
    image = np.asarray(image, np.float64)
    if image.max() > 1:
        image = image / 255.0
    image = image**random_gamma
    image = image * random_brightness
    image = image + (
        random_color_image[..., None]
        if isinstance(random_color_image, np.ndarray) and random_color_image.ndim == 2
        else random_color_image
    )
    if normalize_image:
        return center_image(image)
    image = np.clip(image, 0.0, 1.0) - 0.5
    return image.astype(np.float32)


def augment_image_group(
    images: List[np.ndarray],
    rng: Optional[np.random.RandomState] = None,
    enable_color_shift: bool = False,
    normalize_image: bool = True,
) -> List[np.ndarray]:
    """One shared photometric jitter for all views of a sample.

    gamma ~ U(0.8, 1.2), brightness ~ U(0.5, 1.5), optional per-pixel colour shift
    ~ U(-0.1, 0.1) (reference :370-377). rng=None -> identity augmentation.
    """
    random_gamma = 1.0
    random_brightness = 1.0
    random_color_image = 0.0
    if rng is not None:
        random_gamma = rng.uniform(0.8, 1.2)
        random_brightness = rng.uniform(0.5, 1.5)
        if enable_color_shift:
            h, w = images[0].shape[:2]
            random_color_image = rng.rand(h, w) * 0.2 - 0.1
    return [
        augment_image_color(im, random_gamma, random_brightness, random_color_image, normalize_image)
        for im in images
    ]

"""Color-space ops: 8-bit Lab conversion and brightness augmentation.

The reference converts keyframes with ``cv::cvtColor(color, CV_BGR2Lab)`` on
8-bit images (``/root/reference/include/feature_extractor.h:129``). Two
reference quirks preserved here:

1. The image handed to the converter is **RGB-ordered** (train/test convert
   BGR->RGB right after imread, ``src/train.cpp:123``, and live Xtion frames
   arrive RGB) while the conversion code is ``BGR2Lab`` — so OpenCV treats the
   red channel as blue and vice versa. :func:`rgb_to_lab8` reproduces exactly
   that channel assignment (pass ``swap=False`` for a true RGB2Lab).
2. ``CV_BGR2Lab`` on 8-bit inputs runs OpenCV's fixed-point table pipeline
   (``modules/imgproc/src/color_lab.cpp``): a 256-entry sRGB-gamma table
   scaled by ``255 << 3``, a 12-bit integer XYZ matrix with the white point
   folded into the X/Z rows, a 3072-entry cube-root table scaled by
   ``1 << 15``, and ``CV_DESCALE`` round-half-up shifts.

This implementation reproduces that integer pipeline with the tables
precomputed in float32 (OpenCV builds them in softfloat single precision).
**Verified bit-exact against cv2 over all 256^3 inputs** in this
environment's OpenCV 5.0 (see tests/test_cv2_oracle.py); the round-1
float-path implementation differed by up to 2 LSB and was replaced.

Brightness augmentation mirrors ``color += a`` saturation arithmetic on
cv::Mat (``src/train.cpp:115-124``).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

_LAB_SHIFT = 12  # color_lab.cpp lab_shift
_GAMMA_SHIFT = 3
_LAB_SHIFT2 = _LAB_SHIFT + _GAMMA_SHIFT

# OpenCV D65 RGB->XYZ matrix (modules/imgproc/src/color_lab.cpp).
_XYZ_FROM_RGB = np.array(
    [
        (0.412453, 0.357580, 0.180423),
        (0.212671, 0.715160, 0.072169),
        (0.019334, 0.119193, 0.950227),
    ]
)
_D65 = np.array([0.950456, 1.0, 1.088754])


def _build_tables():
    """OpenCV initLabTabs() in float32 (softfloat single precision).

    Table-construction precision matters: float64 tables differ from
    OpenCV's on a handful of entries, which surfaced as 2-LSB output
    diffs before the cv2 golden oracle caught it.
    """
    f255 = np.float32(255.0)
    i = (np.arange(256, dtype=np.float32) / f255).astype(np.float32)
    thresh = np.float32(809.0 / 20000.0)  # 0.04045 as OpenCV spells it
    lo = (i / np.float32(12.92)).astype(np.float32)
    hi = np.power(
        (i + np.float32(0.055)) / np.float32(1.055), np.float32(2.4),
        dtype=np.float32,
    )
    gamma = np.rint(np.float32(255 << _GAMMA_SHIFT) * np.where(i <= thresh, lo, hi))

    n = (255 * 3 // 2 + 1) * (1 << _GAMMA_SHIFT)  # 3072
    x = (np.arange(n, dtype=np.float32) / np.float32(255 << _GAMMA_SHIFT)).astype(
        np.float32
    )
    flo = (x * np.float32(7.787) + np.float32(16.0 / 116.0)).astype(np.float32)
    fhi = np.cbrt(x, dtype=np.float32)
    cbrt = np.rint(
        np.float32(1 << _LAB_SHIFT2)
        * np.where(x < np.float32(0.008856), flo, fhi)
    )

    coeffs = np.zeros((3, 3), np.int32)
    for row in range(3):
        for col in range(3):
            coeffs[row, col] = np.rint(
                (1 << _LAB_SHIFT)
                * np.float32(
                    np.float32(_XYZ_FROM_RGB[row, col]) / np.float32(_D65[row])
                )
            )
    return gamma.astype(np.int32), cbrt.astype(np.int32), coeffs


_GAMMA_TAB, _CBRT_TAB, _COEFFS = _build_tables()
_L_SCALE = (116 * 255 + 50) // 100
_L_SHIFT = -((16 * 255 * (1 << _LAB_SHIFT2) + 50) // 100)


def _descale(v: jnp.ndarray, n: int) -> jnp.ndarray:
    """CV_DESCALE: round-half-up arithmetic shift."""
    return (v + (1 << (n - 1))) >> n


def rgb_to_lab8(image: jnp.ndarray, swap: bool = True) -> jnp.ndarray:
    """[..., 3] uint8 -> [..., 3] uint8 Lab (L*255/100, a+128, b+128).

    With ``swap=True`` (default) channel 0 is fed to OpenCV's blue slot,
    reproducing the reference's BGR2Lab-on-RGB behavior
    (feature_extractor.h:129 applied to the RGB image of train.cpp:123).
    Bit-exact with ``cv2.cvtColor(..., COLOR_BGR2Lab)``. The 256- and
    3072-entry tables (13 KB) are gathered per pixel; they stay in cache.
    """
    img = image.astype(jnp.int32)
    if swap:
        b8, g8, r8 = img[..., 0], img[..., 1], img[..., 2]
    else:
        r8, g8, b8 = img[..., 0], img[..., 1], img[..., 2]

    gamma = jnp.asarray(_GAMMA_TAB)
    cbrt = jnp.asarray(_CBRT_TAB)
    r = jnp.take(gamma, r8)
    g = jnp.take(gamma, g8)
    b = jnp.take(gamma, b8)

    c = _COEFFS
    fx = jnp.take(cbrt, _descale(r * c[0, 0] + g * c[0, 1] + b * c[0, 2], _LAB_SHIFT))
    fy = jnp.take(cbrt, _descale(r * c[1, 0] + g * c[1, 1] + b * c[1, 2], _LAB_SHIFT))
    fz = jnp.take(cbrt, _descale(r * c[2, 0] + g * c[2, 1] + b * c[2, 2], _LAB_SHIFT))

    l_val = _descale(_L_SCALE * fy + _L_SHIFT, _LAB_SHIFT2)
    a_val = _descale(500 * (fx - fy) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    b_val = _descale(200 * (fy - fz) + (128 << _LAB_SHIFT2), _LAB_SHIFT2)
    out = jnp.stack([l_val, a_val, b_val], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def adjust_brightness(image: jnp.ndarray, delta: int) -> jnp.ndarray:
    """Saturating uint8 brightness shift: cv::Mat += scalar (train.cpp:124)."""
    shifted = image.astype(jnp.int16) + jnp.int16(delta)
    return jnp.clip(shifted, 0, 255).astype(jnp.uint8)


def hflip(image: jnp.ndarray) -> jnp.ndarray:
    """Horizontal flip, cv::flip(im, 1) (train.cpp:132-141)."""
    return image[..., ::-1, :] if image.ndim >= 3 else image[:, ::-1]

"""Depth-adaptive color-patch extraction as one batched gather.

The reference's hottest preprocessing loop
(``/root/reference/include/feature_extractor.h:125-175``): for every selected
pixel, crop a ``(2*floor(patch_size/(2*depth))+1)``-sized window around it
from the reflect-padded Lab image and ``cv::resize`` it to
``patch_size_reduce x patch_size_reduce`` (uint8 bilinear), producing
``R*R*3`` feature values per pixel.

All P windows are resampled simultaneously. Each output pixel
of each window needs 4 taps whose coordinates depend on the per-point window
size, so the whole op is a single gather of shape [P, R, R, 4taps, 3] from
the padded image plus fixed-point weight arithmetic — no per-pixel loops, no
dynamic shapes.

Resize semantics follow OpenCV's 8U INTER_LINEAR path (see ``ops/resize.py``):
``src = (dst+0.5)*scale-0.5``, border-clamped taps, weights in 1/2048ths,
rounding ``(acc + 2^21) >> 22``.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

_COEF_SCALE = 2048


def reflect_pad_image(image: jnp.ndarray, border: int) -> jnp.ndarray:
    """cv::copyMakeBorder BORDER_REFLECT (edge pixel duplicated) — np 'symmetric'."""
    pad = [(border, border), (border, border)] + [(0, 0)] * (image.ndim - 2)
    return jnp.pad(image, pad, mode="symmetric")


def _window_taps(
    half: jnp.ndarray, reduce_size: int
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Per-point 1D tap offsets/weights for a (2*half+1) -> reduce resize.

    Returns (tap0, tap1, w0, w1), each [P, R]; offsets are relative to the
    window origin (point - half).
    """
    w = (2 * half + 1).astype(jnp.float32)  # [P]
    j = jnp.arange(reduce_size, dtype=jnp.float32)  # [R]
    scale = w[:, None] / reduce_size
    fx = (j[None, :] + 0.5) * scale - 0.5
    sx = jnp.floor(fx).astype(jnp.int32)
    frac = fx - sx.astype(jnp.float32)
    wi = (2 * half + 1)[:, None]  # [P, 1] int
    frac = jnp.where(sx < 0, 0.0, frac)
    sx = jnp.maximum(sx, 0)
    frac = jnp.where(sx >= wi - 1, 0.0, frac)
    sx = jnp.minimum(sx, wi - 1)
    sx1 = jnp.minimum(sx + 1, wi - 1)
    w1 = jnp.round(frac * _COEF_SCALE).astype(jnp.int32)
    w0 = jnp.round((1.0 - frac) * _COEF_SCALE).astype(jnp.int32)
    return sx, sx1, w0, w1


@partial(jax.jit, static_argnames=("patch_size", "reduce_size"))
def extract_patches(
    padded_lab: jnp.ndarray,  # [H+2B, W+2B, 3] uint8, B = patch_size
    xs: jnp.ndarray,  # [P] int32 pixel x (unpadded coords)
    ys: jnp.ndarray,  # [P] int32 pixel y
    depth_m: jnp.ndarray,  # [P] float32 depth in meters (> 0 where valid)
    patch_size: int,
    reduce_size: int,
) -> jnp.ndarray:  # [P, R, R, 3] uint8
    hp, wp = padded_lab.shape[0], padded_lab.shape[1]
    border = patch_size

    # C++ int truncation: current_size_half = patch_size / (2.0 * depth)
    # (feature_extractor.h:140). Guard depth<=0 (masked points) with half=0.
    safe_depth = jnp.maximum(depth_m, 1e-6)
    half = jnp.floor(patch_size / (2.0 * safe_depth)).astype(jnp.int32)
    half = jnp.where(depth_m > 0, jnp.minimum(half, border), 0)

    ty0, ty1, wy0, wy1 = _window_taps(half, reduce_size)  # [P, R]
    tx0, tx1, wx0, wx1 = _window_taps(half, reduce_size)

    oy = (ys + border - half)[:, None]  # window origin in padded coords
    ox = (xs + border - half)[:, None]
    gy0, gy1 = oy + ty0, oy + ty1  # [P, R]
    gx0, gx1 = ox + tx0, ox + tx1

    flat = padded_lab.reshape(hp * wp, 3).astype(jnp.int32)

    def tap(gy, gx):  # [P, R], [P, R] -> [P, R, R, 3]
        idx = gy[:, :, None] * wp + gx[:, None, :]
        return jnp.take(flat, idx, axis=0)

    v00 = tap(gy0, gx0)
    v01 = tap(gy0, gx1)
    v10 = tap(gy1, gx0)
    v11 = tap(gy1, gx1)

    wx0b, wx1b = wx0[:, None, :, None], wx1[:, None, :, None]
    wy0b, wy1b = wy0[:, :, None, None], wy1[:, :, None, None]
    row0 = v00 * wx0b + v01 * wx1b
    row1 = v10 * wx0b + v11 * wx1b
    acc = row0 * wy0b + row1 * wy1b
    out = (acc + (1 << 21)) >> 22
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("patch_size", "reduce_size", "stride"))
def extract_patches_grid(
    padded_lab: jnp.ndarray,  # [H+2B, W+2B, 3] uint8
    depth_grid: jnp.ndarray,  # [gh, gw] float32 meters (<= 0 -> masked)
    patch_size: int,
    reduce_size: int,
    stride: int,
) -> jnp.ndarray:  # [gh, gw, R, R, 3] uint8
    """:func:`extract_patches` at every point of the stride grid; the
    extractor's patch stage. Points with depth <= 0 get the h=0 window."""
    gh, gw = depth_grid.shape
    ys = jnp.repeat(jnp.arange(gh, dtype=jnp.int32) * stride, gw)
    xs = jnp.tile(jnp.arange(gw, dtype=jnp.int32) * stride, gh)
    out = extract_patches(
        padded_lab, xs, ys, depth_grid.reshape(-1), patch_size, reduce_size
    )
    return out.reshape(gh, gw, reduce_size, reduce_size, 3)

"""Calibrated backprojection of depth images to world coordinates.

The one formula the reference applies in three places
(``/root/reference/include/feature_extractor.h:200-232``,
``src/segmenter.cpp:466-488``): build ``[d*x, d*y, d]`` per pixel (depth in
meters), map through ``R @ K^-1`` and add ``t``; pixels with depth outside
``[d_min, d_max]`` become NaN.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=())
def backproject(
    depth_mm: jnp.ndarray,  # [H, W] uint16 depth in millimeters
    intrinsic_inverse: jnp.ndarray,  # [3, 3]
    rotation: jnp.ndarray,  # [3, 3]
    translation: jnp.ndarray,  # [3]
    d_min: jnp.ndarray,  # meters (scalar)
    d_max: jnp.ndarray,  # meters (scalar)
) -> jnp.ndarray:  # [H, W, 3] float32 world coordinates, NaN where invalid
    h, w = depth_mm.shape
    depth = depth_mm.astype(jnp.float32) / 1000.0  # feature_extractor.h:209
    xs = jax.lax.broadcasted_iota(jnp.float32, (h, w), 1)
    ys = jax.lax.broadcasted_iota(jnp.float32, (h, w), 0)
    # Strict inequalities: the cloud path rejects depth < d_min or > d_max
    # (feature_extractor.h:210); note the *mask* path uses >= d_min_mm in
    # millimeters (feature_extractor.h:62) — both are honored by callers.
    valid = (depth >= d_min) & (depth <= d_max)
    pix = jnp.stack([depth * xs, depth * ys, depth], axis=-1)  # [H, W, 3]
    # precision=HIGHEST: a float32 matmul may otherwise run in TF32 (or
    # bf16), which costs ~mm-scale error in world coordinates.
    m = jnp.matmul(rotation, intrinsic_inverse, precision=jax.lax.Precision.HIGHEST)
    world = (
        jnp.matmul(pix, m.T, precision=jax.lax.Precision.HIGHEST) + translation
    )
    return jnp.where(valid[..., None], world, jnp.nan)


def depth_valid_mask(
    depth_mm: jnp.ndarray, d_min: float, d_max: float
) -> jnp.ndarray:
    """Point-selection mask in millimeter units (feature_extractor.h:43-62).

    ``depth_mm >= d_min*1000 and depth_mm <= d_max*1000``, evaluated on the
    raw uint16 values like the reference's mm-domain comparison.
    """
    d = depth_mm.astype(jnp.float32)
    return (d >= d_min * 1000.0) & (d <= d_max * 1000.0)

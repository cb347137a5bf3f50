"""Seeded synthetic RGB-D keyframes and local-map clouds at sensor shapes.

Used by the benchmark, the chip smoke run and the measurement scripts, so
they all drive the pipelines with the same kind of data.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from .calibration import Calibration

VGA = (480, 640)  # Xtion keyframes (SURVEY.md:163)
FOCAL = 525.0


def vga_calibration(h: int = VGA[0], w: int = VGA[1]) -> Calibration:
    return Calibration(
        intrinsic=np.array(
            [[FOCAL, 0, w / 2], [0, FOCAL, h / 2], [0, 0, 1]]
        ),
        rotation=np.eye(3),
        translation=np.zeros(3),
    )


def make_depth(rng: np.random.Generator, h: int = VGA[0], w: int = VGA[1]) -> np.ndarray:
    """Piecewise-smooth indoor-style depth in mm (NOT white noise).

    Real RGB-D keyframes are smooth surfaces with step edges at object
    boundaries plus sensor speckle and holes; per-pixel uniform noise is an
    adversarial worst case for depth-adaptive windows that no real scene
    produces.
    """
    ys, xs = np.mgrid[0:h, 0:w]
    depth = (
        3000.0
        + 1500.0 * np.sin(xs / w * np.pi * rng.uniform(0.5, 2.0))
        + 1000.0 * (ys / h) * rng.uniform(0.5, 3.0)
    )
    for _ in range(6):  # furniture-like fronto-parallel boxes
        y0, x0 = rng.integers(0, h - 80), rng.integers(0, w - 120)
        bh, bw = rng.integers(60, 180), rng.integers(80, 240)
        depth[y0 : y0 + bh, x0 : x0 + bw] = rng.uniform(700, 2500)
    depth += rng.normal(0, 15, (h, w))  # sensor noise
    holes = rng.random((h, w)) < 0.02  # dropouts
    depth[holes] = 0
    return np.clip(depth, 0, 15500).astype(np.uint16)


def make_frames(
    rng: np.random.Generator, n: int, h: int = VGA[0], w: int = VGA[1]
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """``n`` (rgb uint8 [H, W, 3], depth uint16 [H, W]) keyframes."""
    return [
        (rng.integers(0, 256, (h, w, 3), dtype=np.uint8), make_depth(rng, h, w))
        for _ in range(n)
    ]


def make_cloud(
    rng: np.random.Generator,
    frames: Sequence[Tuple[np.ndarray, np.ndarray]],
    n_points: int,
    offsets: Optional[Sequence[np.ndarray]] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """A local map of BACKPROJECTED keyframe surfaces: (points [N, 3],
    rgb [N, 3] in [0, 1]).

    Like the local maps the reference's mapper hands to fuseCloudWithNodes
    (segmenter.cpp:518-560), points lie on the frames' piecewise-smooth
    surfaces; a uniform-random box cloud would be an adversarial worst case
    for the permutohedral lattice (nearly every splat on its own vertex).
    Frame ``f``'s points are shifted by ``offsets[f]``, the world position of
    its camera (default: a drift of (0.05, 0.02, 0) m per keyframe).

    Points are backprojected from pixel centres. From integer pixel
    coordinates they would reproject exactly onto pixel edges, where the
    projector's int() truncation is a tie that one ulp of rounding decides.
    """
    if offsets is None:
        offsets = [np.array([0.05, 0.02, 0.0]) * f for f in range(len(frames))]
    h, w = frames[0][1].shape
    cx, cy = w / 2, h / 2
    pts, cols = [], []
    per_frame = n_points // len(frames)
    for f, (rgb, depth_mm) in enumerate(frames):
        d = depth_mm.astype(np.float32) / 1000.0
        count = per_frame if f < len(frames) - 1 else n_points - per_frame * f
        ys = rng.integers(0, h, count)
        xs = rng.integers(0, w, count)
        z = d[ys, xs]
        z = np.where(z > 0, z, 2.0)
        u, v = xs + 0.5, ys + 0.5
        pts.append(
            np.stack([(u - cx) / FOCAL * z, (v - cy) / FOCAL * z, z], axis=1)
            + np.asarray(offsets[f])
        )
        cols.append(rgb[ys, xs].astype(np.float32) / 255.0)
    return (
        np.concatenate(pts).astype(np.float32),
        np.concatenate(cols).astype(np.float32),
    )

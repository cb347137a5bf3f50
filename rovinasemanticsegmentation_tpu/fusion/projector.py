"""Z-buffered projection of map point clouds into camera images.

Array-program equivalent of fps_mapper's ``MultiProjector::project`` used at
``/root/reference/src/segmenter.cpp:578``: given a local-map cloud and a
keyframe pose, produce (a) a z-buffer and (b) an index image mapping each
pixel of the (vertically stacked) multi-camera image to the nearest cloud
point, or -1. The projector is initialized from the per-camera calibrations
(``segmenter.cpp:144-243``) with ``min_distance = depth_min``
(``segmenter.cpp:240``).

Scatter-min over a race-free two-pass trick: (1) scatter-min point depths per
pixel; (2) among points whose depth equals the buffer, scatter-min the point
index — deterministic tie-breaking on the lowest index.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.calibration import Calibration

_BIG = jnp.float32(3.0e38)



def _project_pixels(
    points, rotation_inv, translation_inv, intrinsics,
    min_distance, max_distance, *, height, width,
):
    """Shared camera transform + pixel assignment for both projectors.

    Returns ``(flat [C3*N] i32, zf [C3*N] f32)``: the stacked-image flat
    pixel id per (camera, point) — the one-past-the-end OOB slot for
    invalid points — and the camera depth (_BIG where invalid). The int()
    truncation and validity rule is segmenter.cpp:578-588's.
    """
    ncam = rotation_inv.shape[0]
    npix = ncam * height * width

    cam = (
        jnp.einsum(
            "cij,nj->cni", rotation_inv, points,
            precision=jax.lax.Precision.HIGHEST,
        )
        + translation_inv[:, None, :]
    )  # [C3, N, 3]
    z = cam[..., 2]
    uvw = jnp.einsum(
        "cij,cnj->cni", intrinsics, cam, precision=jax.lax.Precision.HIGHEST
    )
    safe_z = jnp.where(z > 0, z, 1.0)
    px = (uvw[..., 0] / safe_z).astype(jnp.int32)
    py = (uvw[..., 1] / safe_z).astype(jnp.int32)
    valid = (
        (z >= min_distance)
        & (z <= max_distance)
        & (px >= 0)
        & (px < width)
        & (py >= 0)
        & (py < height)
    )
    # Stack cameras vertically (projector image = ncam*H x W,
    # segmenter.cpp:237).
    rows = py + jnp.arange(ncam, dtype=jnp.int32)[:, None] * height
    flat = jnp.where(valid, rows * width + px, npix).reshape(-1)
    zf = jnp.where(valid, z, _BIG).reshape(-1)
    return flat, zf


@partial(jax.jit, static_argnames=("height", "width"))
def project_zbuffer(
    points: jnp.ndarray,  # [N, 3] world points
    rotation_inv: jnp.ndarray,  # [C3, 3, 3] world->camera rotations
    translation_inv: jnp.ndarray,  # [C3, 3]
    intrinsics: jnp.ndarray,  # [C3, 3, 3]
    min_distance: jnp.ndarray,  # scalar meters
    max_distance: jnp.ndarray,  # scalar meters
    *,
    height: int,
    width: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """-> (zbuffer [C3*H, W] f32 (inf empty), index image [C3*H, W] i32 (-1))."""
    ncam = rotation_inv.shape[0]
    n = points.shape[0]

    flat, zf = _project_pixels(
        points, rotation_inv, translation_inv, intrinsics,
        min_distance, max_distance, height=height, width=width,
    )

    zbuf = jnp.full((ncam * height * width + 1,), _BIG, jnp.float32)
    zbuf = zbuf.at[flat].min(zf)

    # Tie-break equal depths by smallest point index.
    winner = zbuf[flat] == zf
    ids = jnp.tile(jnp.arange(n, dtype=jnp.int32)[None], (ncam, 1)).reshape(-1)
    idx_buf = jnp.full((ncam * height * width + 1,), n, jnp.int32)
    idx_buf = idx_buf.at[jnp.where(winner, flat, ncam * height * width)].min(ids)

    zbuffer = zbuf[:-1].reshape(ncam * height, width)
    index_image = idx_buf[:-1].reshape(ncam * height, width)
    index_image = jnp.where(index_image == n, -1, index_image)
    zbuffer = jnp.where(index_image < 0, jnp.inf, zbuffer)
    return zbuffer, index_image


@partial(jax.jit, static_argnames=("height", "width"))
def project_winners(
    points: jnp.ndarray,  # [N, 3] world points
    rotation_inv: jnp.ndarray,  # [C3, 3, 3]
    translation_inv: jnp.ndarray,  # [C3, 3]
    intrinsics: jnp.ndarray,  # [C3, 3, 3]
    min_distance: jnp.ndarray,
    max_distance: jnp.ndarray,
    *,
    height: int,
    width: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Scatter-free z-buffer resolution for posterior fusion.

    Returns ``(won [C3*N] bool, flat [C3*N] i32)``: per (camera, point),
    whether the point is the nearest one landing on its pixel (the z-buffer
    winner, ties to the lowest point index — the same rule as
    :func:`project_zbuffer`), and the stacked-image flat pixel id it lands
    on. Each point occupies exactly one pixel per camera, so fusion needs no
    index IMAGE at all: a gather of the winner pixels' posteriors replaces
    the reference's per-pixel accumulation loop (segmenter.cpp:589-616).
    Implementation is sort-based: lexicographic sort by (pixel, depth,
    slot) puts each pixel's winner first in its run. Whether a scatter-min
    is faster on the GPU is not measured yet (ROADMAP S7).
    """
    ncam = rotation_inv.shape[0]
    n = points.shape[0]
    npix = ncam * height * width

    flat, zf = _project_pixels(
        points, rotation_inv, translation_inv, intrinsics,
        min_distance, max_distance, height=height, width=width,
    )

    # Within one camera block, slot order == point-index order, and camera
    # blocks never share a pixel row — so the slot id is a faithful
    # tie-break key for "lowest point index".
    slot = jnp.arange(ncam * n, dtype=jnp.int32)
    sorted_flat, _, sorted_slot = jax.lax.sort((flat, zf, slot), num_keys=3)
    is_start = jnp.concatenate(
        [jnp.ones((1,), bool), sorted_flat[1:] != sorted_flat[:-1]]
    )
    won_sorted = is_start & (sorted_flat < npix)
    # Unsort via the inverse permutation (sorting a permutation is identity,
    # and the carried iota lands each slot's sorted position at index slot).
    _, pos = jax.lax.sort(
        (sorted_slot, jnp.arange(ncam * n, dtype=jnp.int32)), num_keys=1
    )
    return won_sorted[pos], flat


@dataclass
class MultiProjector:
    """Per-camera calibrations -> stacked-image projection."""

    rotations_inv: np.ndarray  # [C3, 3, 3]
    translations_inv: np.ndarray  # [C3, 3]
    intrinsics: np.ndarray  # [C3, 3, 3]
    height: int
    width: int
    min_distance: float = 0.0
    max_distance: float = 1.0e9

    @classmethod
    def from_calibrations(
        cls,
        calibrations: Sequence[Calibration],
        height: int,
        width: int,
        min_distance: float = 0.0,
        max_distance: float = 1.0e9,
    ) -> "MultiProjector":
        rot_inv, t_inv, ks = [], [], []
        for c in calibrations:
            r = c.rotation.T  # inverse of the camera->base extrinsic
            rot_inv.append(r)
            t_inv.append(-r @ c.translation)
            ks.append(c.intrinsic)
        return cls(
            rotations_inv=np.stack(rot_inv).astype(np.float32),
            translations_inv=np.stack(t_inv).astype(np.float32),
            intrinsics=np.stack(ks).astype(np.float32),
            height=int(height),
            width=int(width),
            min_distance=float(min_distance),
            max_distance=float(max_distance),
        )

    def project(
        self, points: np.ndarray, pose: np.ndarray
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Project the cloud as seen from keyframe ``pose`` (4x4, base->world).

        Matches the reference call pattern
        ``projector.project(zbuf, idx, pose.inverse(), cloud)``
        (segmenter.cpp:578): the pose inverse takes world points into the
        keyframe's base frame, then per-camera extrinsic inverses map into
        each camera.
        """
        pose = np.asarray(pose, dtype=np.float32)
        rp = pose[:3, :3].T
        tp = -rp @ pose[:3, 3]
        # Compose: cam <- base <- world.
        rot = self.rotations_inv @ rp[None]
        trans = (
            np.einsum("cij,j->ci", self.rotations_inv, tp) + self.translations_inv
        )
        return project_zbuffer(
            jnp.asarray(points, dtype=jnp.float32),
            jnp.asarray(rot),
            jnp.asarray(trans),
            jnp.asarray(self.intrinsics),
            jnp.float32(self.min_distance),
            jnp.float32(self.max_distance),
            height=self.height,
            width=self.width,
        )

"""Per-keyframe feature extraction: fused, batched XLA preprocessing.

Capability parity with ``Features::FeatureExtractor::extract``
(``/root/reference/include/feature_extractor.h:25-392``), re-designed from
per-pixel C++ loops into dense tensor ops over the full stride grid:

- the reference appends one DataPoint per *valid* pixel (depth inside
  ``[d_min, d_max]`` in millimeters, feature_extractor.h:56-71, plus label
  conditions per ExtractType, :72-121); here every grid point is computed and
  a boolean ``mask`` carries validity — static shapes, no host round-trips;
- feature vector layout matches :47-51: ``[R*R*3 Lab patch | depth | height |
  normal angle]`` with the same config gating;
- Lab conversion + reflect padding (:129-130), depth-adaptive patch resize
  (:140-142 -> ``ops/patches.py``, one 4-tap gather per output pixel), raw depth in meters (:187-189), height =
  world z of the backprojection (:200-251 -> ``ops/geometry.py``), normal
  angle ``acos(|n_z|)`` with NaN -> -2 (:254-291 -> ``ops/normals.py``).

Label extraction modes mirror ``ExtractType`` (feature_extractor.h:21):
NO_LABEL ignores labels, WITH_ANY_LABEL keeps depth-valid pixels and attaches
labels, WITH_POSITIVE_LABEL additionally requires every layer's label >= 0.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import partial
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.color import rgb_to_lab8
from ..ops.geometry import backproject, depth_valid_mask
from ..ops.normals import normal_angles_grid
from ..ops.patches import extract_patches_grid, reflect_pad_image
from ..utils.calibration import Calibration
from ..utils.config import Config


class ExtractType(enum.Enum):
    WITH_ANY_LABEL = 0
    WITH_POSITIVE_LABEL = 1
    NO_LABEL = 2


@dataclass(frozen=True)
class FeatureConfig:
    """Static feature-extraction parameters (resources/config.json:31-44)."""

    patch_size: int = 77
    patch_size_reduce: int = 11
    use_color_patch: bool = True
    use_depth: bool = True
    use_height: bool = True
    use_normal: bool = True
    d_min: float = 0.5
    d_max: float = 15.0

    @classmethod
    def from_config(cls, conf: Config) -> "FeatureConfig":
        return cls(
            patch_size=conf.get_int("patch_size"),
            patch_size_reduce=conf.get_int("patch_size_reduce"),
            use_color_patch=conf.get_bool("feature_color_patch"),
            use_depth=conf.get_bool("feature_depth"),
            use_height=conf.get_bool("feature_height"),
            use_normal=conf.get_bool("feature_normal"),
            d_min=conf.get_float("depth_min"),
            d_max=conf.get_float("depth_max"),
        )

    @property
    def feature_length(self) -> int:
        """feature_extractor.h:46-51."""
        n = 0
        if self.use_color_patch:
            n += self.patch_size_reduce * self.patch_size_reduce * 3
        if self.use_depth:
            n += 1
        if self.use_height:
            n += 1
        if self.use_normal:
            n += 1
        return n


@dataclass
class FeatureBatch:
    """Dense stride-grid features for one frame.

    ``features[p]`` is meaningful only where ``mask[p]``; masked rows are
    zeroed. ``xs``/``ys`` give the full-resolution pixel of each grid point
    (the reference's x_v/y_v vectors, feature_extractor.h:64-65).
    """

    features: jnp.ndarray  # [P, D] float32
    mask: jnp.ndarray  # [P] bool
    xs: np.ndarray  # [P] int32
    ys: np.ndarray  # [P] int32
    grid_shape: Tuple[int, int]  # (rows, cols) of the stride grid
    labels: Optional[jnp.ndarray] = None  # [P, L] int8 when extracted


@partial(
    jax.jit,
    static_argnames=(
        "stride",
        "patch_size",
        "reduce_size",
        "use_color_patch",
        "use_depth",
        "use_height",
        "use_normal",
    ),
)
def _extract_impl(
    rgb: jnp.ndarray,  # [H, W, 3] uint8 (RGB order)
    depth_mm: jnp.ndarray,  # [H, W] uint16
    intrinsic_inverse: jnp.ndarray,
    rotation: jnp.ndarray,
    translation: jnp.ndarray,
    d_min: jnp.ndarray,
    d_max: jnp.ndarray,
    *,
    stride: int,
    patch_size: int,
    reduce_size: int,
    use_color_patch: bool,
    use_depth: bool,
    use_height: bool,
    use_normal: bool,
):
    h, w = depth_mm.shape
    gys = jnp.arange(0, h, stride, dtype=jnp.int32)
    gxs = jnp.arange(0, w, stride, dtype=jnp.int32)
    ys2d = jnp.broadcast_to(gys[:, None], (gys.size, gxs.size))
    xs2d = jnp.broadcast_to(gxs[None, :], (gys.size, gxs.size))
    ys = ys2d.reshape(-1)
    xs = xs2d.reshape(-1)

    depth_grid_mm = depth_mm[ys2d, xs2d].reshape(-1)
    mask = depth_valid_mask(depth_grid_mm, d_min, d_max)
    depth_m = depth_grid_mm.astype(jnp.float32) / 1000.0

    parts = []
    if use_color_patch:
        lab = rgb_to_lab8(rgb)  # BGR2Lab-on-RGB quirk preserved
        padded = reflect_pad_image(lab, patch_size)
        depth_grid = jnp.where(mask, depth_m, 0.0).reshape(gys.size, gxs.size)
        patches = extract_patches_grid(
            padded, depth_grid,
            patch_size=patch_size, reduce_size=reduce_size, stride=stride,
        )
        parts.append(
            patches.reshape(xs.shape[0], reduce_size * reduce_size * 3).astype(
                jnp.float32
            )
        )

    if use_depth:
        parts.append(depth_m[:, None])

    points = None
    if use_height or use_normal:
        points = backproject(
            depth_mm, intrinsic_inverse, rotation, translation, d_min, d_max
        )
    if use_height:
        height = points[ys2d, xs2d, 2].reshape(-1)
        parts.append(jnp.nan_to_num(height)[:, None])
    if use_normal:
        angles = normal_angles_grid(points, stride)
        parts.append(angles.reshape(-1)[:, None])

    features = jnp.concatenate(parts, axis=1)
    features = jnp.where(mask[:, None], features, 0.0)
    return features, mask, ys, xs


class FeatureExtractor:
    """Stateful wrapper: config + jitted extraction."""

    def __init__(self, config: FeatureConfig):
        self.config = config

    def extract(
        self,
        rgb: jnp.ndarray,
        depth_mm: jnp.ndarray,
        calibration: Calibration,
        stride: int,
        label_extraction: ExtractType = ExtractType.NO_LABEL,
        labels: Optional[Sequence[np.ndarray]] = None,
    ) -> FeatureBatch:
        cfg = self.config
        features, mask, ys, xs = _extract_impl(
            jnp.asarray(rgb),
            jnp.asarray(depth_mm),
            jnp.asarray(calibration.intrinsic_inverse),
            jnp.asarray(calibration.rotation),
            jnp.asarray(calibration.translation),
            jnp.float32(cfg.d_min),
            jnp.float32(cfg.d_max),
            stride=stride,
            patch_size=cfg.patch_size,
            reduce_size=cfg.patch_size_reduce,
            use_color_patch=cfg.use_color_patch,
            use_depth=cfg.use_depth,
            use_height=cfg.use_height,
            use_normal=cfg.use_normal,
        )
        h, w = np.asarray(depth_mm).shape
        grid_shape = (-(-h // stride), -(-w // stride))

        label_arr = None
        if label_extraction != ExtractType.NO_LABEL:
            if not labels:
                raise ValueError("labels required for labeled extraction")
            ys_np, xs_np = np.asarray(ys), np.asarray(xs)
            stacked = np.stack(
                [np.asarray(l)[ys_np, xs_np] for l in labels], axis=1
            ).astype(np.int8)
            label_arr = jnp.asarray(stacked)
            if label_extraction == ExtractType.WITH_POSITIVE_LABEL:
                # All layers must be labeled >= 0 (feature_extractor.h:99-103).
                mask = mask & jnp.all(label_arr >= 0, axis=1)

        return FeatureBatch(
            features=features,
            mask=mask,
            xs=np.asarray(xs),
            ys=np.asarray(ys),
            grid_shape=grid_shape,
            labels=label_arr,
        )

"""Single-frame segmentation: features -> forest -> per-pixel posteriors.

This is the reference's minimum end-to-end slice, mirroring both the offline
evaluator (``/root/reference/src/test_multi.cpp:154-237``) and the online
per-keyframe worker (``src/segmenter.cpp:323-443``):

1. extract stride-grid features (NO_LABEL / WITH_ANY_LABEL);
2. forest multi-class log-posterior per grid point;
3. write per-layer posterior maps at stride resolution — the evaluator
   initializes to -1000 (test_multi.cpp:181) while the online node uses 0
   (segmenter.cpp:358-362); ``fill_value`` selects;
4. bilinear-resize each map to full resolution (test_multi.cpp:199);
5. per-pixel argmax with a -1000 floor: pixels where nothing beats -1000 get
   label -1 (test_multi.cpp:206-216).

The whole slice is one jitted computation over a batch of frames; the stride
grid maps to the posterior image by a plain reshape because grid points are
generated row-major.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..features.extractor import FeatureConfig, _extract_impl
from ..models.forest import Forest, ForestPredictor, _sum_leaf_histograms
from ..ops.forest_pallas import DESCENTS, find_leaves, select_descent
from ..ops.resize import resize_bilinear
from ..utils.calibration import Calibration

ARGMAX_FLOOR = -1000.0  # test_multi.cpp:181,207


def _posterior_maps(post, mask, depth_mm, stride, class_counts, fill_value,
                    out_h, out_w):
    """Stride posteriors -> full-res maps + argmax labels (shared tail)."""
    h, w = depth_mm.shape
    gh, gw = -(-h // stride), -(-w // stride)
    posteriors = []
    labels = []
    for li, c in enumerate(class_counts):
        layer = jnp.where(mask[:, None], post[:, li, :c], fill_value)
        grid_img = layer.reshape(gh, gw, c)
        full = resize_bilinear(grid_img, out_h, out_w)  # [H, W, c]
        max_val = jnp.max(full, axis=-1)
        lbl = jnp.argmax(full, axis=-1).astype(jnp.int8)
        lbl = jnp.where(max_val > ARGMAX_FLOOR, lbl, jnp.int8(-1))
        posteriors.append(full)
        labels.append(lbl)
    return posteriors, labels


_FRAME_STATICS = (
    "stride", "patch_size", "reduce_size", "use_color_patch", "use_depth",
    "use_height", "use_normal", "max_depth", "feat_bits", "descent",
    "interpret", "class_counts", "fill_value", "out_h", "out_w",
)


@partial(jax.jit, static_argnames=_FRAME_STATICS)
def _frame_batch_impl(
    rgb: jnp.ndarray,  # [B, H, W, 3] uint8
    depth_mm: jnp.ndarray,  # [B, H, W] uint16
    intrinsic_inverse: jnp.ndarray,  # [B, 3, 3]
    rotation: jnp.ndarray,  # [B, 3, 3]
    translation: jnp.ndarray,  # [B, 3]
    d_min: jnp.ndarray,
    d_max: jnp.ndarray,
    records: jnp.ndarray,  # [T, N, 2] packed node records
    leaf_hist: jnp.ndarray,  # [T, N, L, C]
    *,
    stride: int,
    patch_size: int,
    reduce_size: int,
    use_color_patch: bool,
    use_depth: bool,
    use_height: bool,
    use_normal: bool,
    max_depth: int,
    feat_bits: int,
    descent: str,
    interpret: bool,
    class_counts: Tuple[int, ...],
    fill_value: float,
    out_h: int,
    out_w: int,
):
    """B keyframes in one dispatch: the frame path of every caller.

    Feature extraction and the posterior tail are ``vmap``-ed over frames;
    the descent and the leaf-histogram sum run once on the concatenated
    [B*P, D] feature matrix. Per-frame outputs do not depend on B (this is
    the data parallelism over keyframes of SURVEY.md 2.5, replacing the
    reference's one-frame-at-a-time worker, src/segmenter.cpp:323-443).
    Returns one ``(posteriors, labels)`` pair of per-layer lists per frame.
    """
    b = rgb.shape[0]

    def extract(rgb1, depth1, kinv1, rot1, trans1):
        features, mask, _, _ = _extract_impl(
            rgb1, depth1, kinv1, rot1, trans1, d_min, d_max,
            stride=stride, patch_size=patch_size, reduce_size=reduce_size,
            use_color_patch=use_color_patch, use_depth=use_depth,
            use_height=use_height, use_normal=use_normal,
        )
        return features, mask

    feats, masks = jax.vmap(extract)(
        rgb, depth_mm, intrinsic_inverse, rotation, translation
    )  # [B, P, D], [B, P]
    p, d = feats.shape[1], feats.shape[2]
    leaves = find_leaves(
        feats.reshape(b * p, d), records, max_depth=max_depth,
        feat_bits=feat_bits, descent=descent, interpret=interpret,
    )
    post = _sum_leaf_histograms(leaf_hist, leaves)  # [B*P, L, Cmax]
    posteriors, labels = jax.vmap(
        lambda po, m, dep: _posterior_maps(
            po, m, dep, stride, class_counts, fill_value, out_h, out_w
        )
    )(post.reshape(b, p, *post.shape[1:]), masks, depth_mm)
    return [
        ([po[i] for po in posteriors], [la[i] for la in labels])
        for i in range(b)
    ]


@dataclass
class SingleFrameResult:
    posteriors: List[jnp.ndarray]  # per layer [H, W, C_l] float32
    labels: List[jnp.ndarray]  # per layer [H, W] int8 (-1 = no vote)


class SingleFramePipeline:
    """features -> RF -> posterior maps -> labels for one calibrated camera.

    ``descent`` names the forest descent (``ops/forest_pallas.py``); by
    default :func:`select_descent` picks it from the platform.
    ``interpret=True`` runs the descent kernel through the Pallas
    interpreter (CPU tests only).
    """

    def __init__(
        self,
        feature_config: FeatureConfig,
        forest: Forest,
        stride: int,
        fill_value: float = ARGMAX_FLOOR,
        descent: Optional[str] = None,
        interpret: bool = False,
    ):
        self.feature_config = feature_config
        self.stride = int(stride)
        self.fill_value = float(fill_value)
        self.class_counts = tuple(forest.class_counts)
        self.descent = descent or select_descent(jax.default_backend())
        if self.descent not in DESCENTS:
            raise ValueError(f"unknown descent {self.descent!r}")
        self.interpret = bool(interpret)
        self.predictor = ForestPredictor(forest)

    def run_batch(
        self,
        rgbs: Sequence[np.ndarray],
        depths_mm: Sequence[np.ndarray],
        calibrations: Sequence[Calibration],
    ) -> List[SingleFrameResult]:
        """Process B keyframes in ONE dispatch; per-frame outputs are those
        of :meth:`run`."""
        return self.run_batch_stacked(
            np.stack([np.asarray(r) for r in rgbs]),
            np.stack([np.asarray(d) for d in depths_mm]),
            np.stack([np.asarray(c.intrinsic_inverse) for c in calibrations]),
            np.stack([np.asarray(c.rotation) for c in calibrations]),
            np.stack([np.asarray(c.translation) for c in calibrations]),
        )

    def frame_statics(self, h: int, w: int) -> dict:
        """The static arguments of :func:`_frame_batch_impl` for HxW frames."""
        cfg = self.feature_config
        return dict(
            stride=self.stride,
            patch_size=cfg.patch_size,
            reduce_size=cfg.patch_size_reduce,
            use_color_patch=cfg.use_color_patch,
            use_depth=cfg.use_depth,
            use_height=cfg.use_height,
            use_normal=cfg.use_normal,
            max_depth=self.predictor.max_depth,
            feat_bits=self.predictor.feat_bits,
            descent=self.descent,
            interpret=self.interpret,
            class_counts=self.class_counts,
            fill_value=self.fill_value,
            out_h=h,
            out_w=w,
        )

    def run_batch_stacked(
        self,
        rgb_stack,  # [B, H, W, 3] uint8 (host or device-resident)
        depth_stack,  # [B, H, W] uint16
        kinv_stack,  # [B, 3, 3]
        rot_stack,  # [B, 3, 3]
        trans_stack,  # [B, 3]
    ) -> List[SingleFrameResult]:
        """Like :meth:`run_batch` on pre-stacked inputs; device-resident
        arrays pass through without a host round trip."""
        cfg = self.feature_config
        h, w = int(depth_stack.shape[1]), int(depth_stack.shape[2])
        outs = _frame_batch_impl(
            jnp.asarray(rgb_stack),
            jnp.asarray(depth_stack),
            jnp.asarray(kinv_stack, jnp.float32),
            jnp.asarray(rot_stack, jnp.float32),
            jnp.asarray(trans_stack, jnp.float32),
            jnp.float32(cfg.d_min),
            jnp.float32(cfg.d_max),
            self.predictor.records,
            self.predictor.leaf_hist,
            **self.frame_statics(h, w),
        )
        return [
            SingleFrameResult(posteriors=po, labels=la) for po, la in outs
        ]

    def run(
        self,
        rgb: np.ndarray,
        depth_mm: np.ndarray,
        calibration: Calibration,
    ) -> SingleFrameResult:
        return self.run_batch([rgb], [depth_mm], [calibration])[0]

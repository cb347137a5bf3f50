"""One-dispatch streaming: a keyframe batch PLUS its local maps.

The reference runs a frame worker and a map worker concurrently
(``src/segmenter.cpp:227-232``). Here one jit carries the
whole batch's frame path (features -> descent -> posteriors -> labels) AND
every local map those keyframes feed (node fusion -> device lattice build
-> fused multi-layer CRF), so steady state is ONE dispatch per keyframe
batch. The map's data dependency on its keyframes' posteriors is an edge
inside the graph instead of a host-side thread handoff. Whether this beats
the two-worker form on the GPU is not measured yet (ROADMAP D6).

Serving latency note: the Segmenter keeps the reference's worker-thread
architecture (per-keyframe latency matters there); this module is the
throughput path (bench, batch/offline serving).
"""

from __future__ import annotations

from functools import partial
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .local_map import LocalMapPipeline, _map_fused
from .single_frame import _FRAME_STATICS, SingleFramePipeline, _frame_batch_impl


def pack_poses(projector, poses: Sequence[np.ndarray]) -> np.ndarray:
    """[K, C3, 3, 4] rot_inv | t_inv pose pack (segmenter.cpp:561-571).

    The same math as LocalMapPipeline._prep_nodes, without the posterior
    plumbing (the streaming step takes posteriors straight from the frame
    stage inside the graph).
    """
    rot_all, t_all = [], []
    for pose in poses:
        pose = np.asarray(pose, np.float32)
        rp = pose[:3, :3].T
        tp = -rp @ pose[:3, 3]
        rot_all.append(projector.rotations_inv @ rp[None])
        t_all.append(
            np.einsum("cij,j->ci", projector.rotations_inv, tp)
            + projector.translations_inv
        )
    return np.concatenate(
        [np.stack(rot_all), np.stack(t_all)[..., None]], axis=-1
    ).astype(np.float32)


@partial(
    jax.jit,
    static_argnames=_FRAME_STATICS + (
        "map_every", "maps_per_batch", "num_points", "blocks", "m_bucket",
        "n_iterations", "unknown_labels", "min_distance", "max_distance",
        "xyz_kernel", "rgb_kernel", "kernel_weight",
    ),
)
def _stream_step(
    rgb,  # [B, H, W, 3] uint8
    depth_mm,  # [B, H, W] uint16
    kinv, rot, trans,  # [B, 3, 3] x2, [B, 3]
    d_min, d_max,
    records, leaf_hist,
    clouds,  # [Mb, N, 3]
    cloud_rgb,  # [N, 3] (shared) or [Mb, N, 3]
    pose_packed,  # [Mb, K, C3, 3, 4]
    intrinsics,  # [C3, 3, 3]
    *,
    stride, patch_size, reduce_size, use_color_patch, use_depth,
    use_height, use_normal, max_depth, feat_bits, descent, interpret,
    class_counts, fill_value, out_h, out_w,
    map_every: int, maps_per_batch: int, num_points: int,
    blocks: Tuple[int, ...], m_bucket: int, n_iterations: int,
    unknown_labels: Tuple[int, ...],
    min_distance: float, max_distance: float,
    xyz_kernel: float, rgb_kernel: float, kernel_weight: float,
):
    """The fused step. Returns (frame_labels per frame per layer,
    map_labels per map per layer, vertex counts per map)."""
    outs = _frame_batch_impl(
        rgb, depth_mm, kinv, rot, trans, d_min, d_max, records, leaf_hist,
        stride=stride, patch_size=patch_size, reduce_size=reduce_size,
        use_color_patch=use_color_patch, use_depth=use_depth,
        use_height=use_height, use_normal=use_normal,
        max_depth=max_depth, feat_bits=feat_bits, descent=descent,
        interpret=interpret, class_counts=class_counts,
        fill_value=fill_value, out_h=out_h, out_w=out_w,
    )
    frame_labels = [la for _, la in outs]
    map_labels, m_counts = [], []
    crgb_per_map = cloud_rgb.ndim == 3
    for m in range(maps_per_batch):
        # One camera (C3 from intrinsics), map_every nodes: the posterior
        # pytree _map_fused expects, with leaves traced from the frame
        # stage — the keyframe->map handoff is a graph edge, not a host
        # thread handoff.
        posts = tuple(
            (tuple(outs[m * map_every + k][0]),) for k in range(map_every)
        )
        labels_m, mc = _map_fused(
            clouds[m],
            cloud_rgb[m] if crgb_per_map else cloud_rgb,
            pose_packed[m],
            intrinsics,
            posts,
            height=out_h, width=out_w, num_points=num_points,
            blocks=blocks, m_bucket=m_bucket, n_iterations=n_iterations,
            unknown_labels=unknown_labels,
            min_distance=min_distance, max_distance=max_distance,
            xyz_kernel=xyz_kernel, rgb_kernel=rgb_kernel,
            kernel_weight=kernel_weight,
        )
        map_labels.append(labels_m)
        m_counts.append(mc)
    return frame_labels, map_labels, m_counts


class StreamingPipeline:
    """Drive :func:`_stream_step` with the two pipelines' configs.

    ``map_pipeline`` must have a VALIDATED vertex bucket for the cloud
    size (run one map through ``label_map``/``run_device`` first — the
    bench warmup does); maps here run sync-free, with overflow counts
    handed to the map pipeline's async drain (a would-be overflow poisons
    that map's labels to Unknown on device, overtly, and grows the bucket
    for subsequent maps).
    """

    def __init__(
        self,
        frame_pipeline: SingleFramePipeline,
        map_pipeline: LocalMapPipeline,
        map_every: int,
    ):
        if not map_pipeline.crf.use_dense_crf:
            raise ValueError("streaming fuses the dense-CRF map path")
        self.frames = frame_pipeline
        self.maps = map_pipeline
        self.map_every = int(map_every)

    def run_staged(
        self,
        rgb_stack,  # [B, H, W, 3] (device-resident preferred)
        depth_stack,  # [B, H, W]
        kinv, rot, trans,
        clouds,  # [Mb, N, 3] with Mb = B // map_every
        cloud_rgb,  # [N, 3] or [Mb, N, 3]
        pose_packed,  # [Mb, K, C3, 3, 4] (see :func:`pack_poses`)
    ) -> Tuple[List[List[jnp.ndarray]], List[List[jnp.ndarray]]]:
        """One dispatch; returns (frame_labels, map_labels), all device-
        resident and un-synced."""
        fp, mp = self.frames, self.maps
        cfg = fp.feature_config
        b = int(rgb_stack.shape[0])
        h, w = int(depth_stack.shape[1]), int(depth_stack.shape[2])
        n = int(clouds.shape[1])
        maps_per_batch = b // self.map_every
        if maps_per_batch != int(clouds.shape[0]):
            raise ValueError(
                f"{int(clouds.shape[0])} clouds for {maps_per_batch} maps"
            )
        if n not in mp._m_checked:
            raise ValueError(
                f"vertex bucket not validated for cloud size {n}; run one "
                "map through LocalMapPipeline first"
            )
        mp._drain_overflow_flags()
        frame_labels, map_labels, m_counts = _stream_step(
            jnp.asarray(rgb_stack), jnp.asarray(depth_stack),
            jnp.asarray(kinv), jnp.asarray(rot), jnp.asarray(trans),
            jnp.float32(cfg.d_min), jnp.float32(cfg.d_max),
            fp.predictor.records, fp.predictor.leaf_hist,
            jnp.asarray(clouds), jnp.asarray(cloud_rgb),
            jnp.asarray(pose_packed), mp._intr_dev,
            **fp.frame_statics(h, w),
            map_every=self.map_every, maps_per_batch=maps_per_batch,
            num_points=n, blocks=tuple(mp.class_counts),
            m_bucket=mp._m_bucket, n_iterations=mp.crf.iterations,
            unknown_labels=tuple(mp.unknown_labels),
            min_distance=float(mp.projector.min_distance),
            max_distance=float(mp.projector.max_distance),
            xyz_kernel=float(mp.crf.xyz_kernel),
            rgb_kernel=float(mp.crf.rgb_kernel),
            kernel_weight=float(mp.crf.kernel_weight),
        )
        for mc in m_counts:
            mp._pending_m.append((mp._m_bucket, mc))
        return frame_labels, map_labels

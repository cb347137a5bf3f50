"""The online segmentation runtime: queues, keyframe gating, fusion, serving.

Capability parity with class ``Segmenter``
(``/root/reference/src/segmenter.cpp``, ``include/segmenter.h:44-140``),
re-designed without ROS: frames and map nodes arrive via method calls (the
HTTP transport lives in ``serve/services.py``), compute runs through the
jitted single-frame and local-map pipelines, and the three query services are
plain methods mirroring the ``srv`` schemas.

Semantics preserved:

- keyframe gating: skip when both the translation delta < 0.07 m and the
  rotation delta < 0.1 rad (segmenter.cpp:257-265, resources/config.json:92-93);
  the initial pose sits far away so the first frame always passes (:131-133);
- frame-id alignment: the depth frame's seq must match and the color seq may
  trail by < 3, else the frame is dropped (:278-287); requesting an already
  cleared id raises (:288-292);
- worker A (per-frame inference) and worker B (map fusion) are daemon threads
  fed by locked deques (:227-232, 323-443, 518-719);
- completeness: a local map fuses only when every camera's result queue has
  reached its last needed seq id (:537-553); stale results are dropped
  (:589-596);
- results are stored per map id and served by the three services (:722-792).
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Deque, Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..features.extractor import FeatureConfig
from ..fusion.projector import MultiProjector
from ..models.forest import Forest, load_forest
from ..pipelines.local_map import CrfParams, LocalMapPipeline, MapNodeFrames
from ..pipelines.single_frame import SingleFramePipeline
from ..utils.calibration import Calibration
from ..utils.config import Config
from ..utils.labels import LayerCoding, parse_color_codings
from .camera import CameraBuffer, parse_name_from_topic

log = logging.getLogger(__name__)


@dataclass
class MapNode:
    """One SLAM keyframe: a MultiImageMapNode's pose and per-camera seq ids."""

    node_id: int
    pose: np.ndarray  # [4, 4] base -> world
    subimage_seqs: List[int]


@dataclass
class LocalMapData:
    """A local map: id, keyframe nodes, and the point cloud."""

    map_id: int
    nodes: List[MapNode]
    cloud_points: np.ndarray  # [N, 3]
    cloud_rgb: Optional[np.ndarray] = None  # [N, 3] in [0, 1]


def rotation_angle(r: np.ndarray) -> float:
    """|angle| of a rotation matrix (Eigen AngleAxis norm)."""
    c = (np.trace(r[:3, :3]) - 1.0) * 0.5
    return float(np.arccos(np.clip(c, -1.0, 1.0)))


class Segmenter:
    """Queue-driven online segmenter."""

    def __init__(
        self,
        config: Config,
        topic_names: Sequence[str],
        forest: Optional[Forest] = None,
        forest_path: Optional[str] = None,
        external_segmentation: Optional[
            Callable[[np.ndarray, np.ndarray], List[np.ndarray]]
        ] = None,
        dump_clouds_to_tmp: bool = False,
        dump_dir: str = "/tmp",
    ):
        # --- camera/topic pairing (segmenter.cpp:46-66)
        self._camera_map: Dict[str, CameraBuffer] = {}
        for topic in topic_names:
            name = parse_name_from_topic(topic)
            if name not in self._camera_map:
                self._camera_map[name] = CameraBuffer(name)
            self._camera_map[name].add_topic(topic)
        if not all(c.is_complete for c in self._camera_map.values()):
            raise RuntimeError(
                "cannot match rgb and depth pairs from the provided topics!"
            )

        # --- layer metadata (segmenter.cpp:72-98)
        self.layers: List[LayerCoding] = parse_color_codings(
            config.get_raw("color_codings")
        )
        self.layer_names = [l.name for l in self.layers]
        self.layer_class_counts = [l.class_count for l in self.layers]
        self.layer_unknown_labels = [l.unknown_label for l in self.layers]

        # --- inference backend (segmenter.cpp:100-117)
        self._external = external_segmentation
        self._forest: Optional[Forest] = None
        if external_segmentation is None:
            if forest is None:
                forest = load_forest(
                    forest_path, class_counts=self.layer_class_counts
                )
            self._forest = forest
        self.feature_config = FeatureConfig.from_config(config)

        # --- runtime params (segmenter.cpp:119-129)
        self.crf_params = CrfParams(
            use_dense_crf=config.get_bool("use_dense_crf"),
            xyz_kernel=config.get_float("dcrf_xyz_kernel"),
            rgb_kernel=config.get_float("dcrf_rgb_kernel"),
            kernel_weight=config.get_float("dcrf_kernel_weight"),
            iterations=config.get_int("dcrf_iterations"),
        )
        self.rf_prediction_stride = config.get_int("rf_prediction_stride")
        self.depth_min = config.get_float("depth_min")
        self.depth_max = config.get_float("depth_max")
        self.keyframe_skip_rotation = config.get_float("keyframe_skip_rotation")
        self.keyframe_skip_translation = config.get_float(
            "keyframe_skip_translation"
        )
        self._dump = dump_clouds_to_tmp
        self._dump_dir = dump_dir

        # --- queues and state (segmenter.h:93-108)
        self._frame_lock = threading.Lock()
        self._cloud_lock = threading.Lock()
        self._cloud_processing_lock = threading.Lock()
        self._cameras_in_order: List[CameraBuffer] = []
        self._image_queues: List[Deque[Tuple[int, np.ndarray, np.ndarray]]] = []
        self._result_queues: List[Deque[Tuple[int, List[np.ndarray]]]] = []
        self._local_map_queue: Deque[LocalMapData] = deque()
        self._cloud_results: List[Tuple[int, List[np.ndarray]]] = []
        self._last_pose = np.eye(4, dtype=np.float32)
        self._last_pose[:3, 3] = 10.0  # far away: first frame always passes
        self._last_key_frame_id = 0
        self._order_initialized = False
        self._projector: Optional[MultiProjector] = None
        self._frame_pipeline: Optional[SingleFramePipeline] = None
        self._map_pipeline: Optional[LocalMapPipeline] = None
        self._camera_h = 0
        self._camera_w = 0
        self._stop = threading.Event()
        self._threads: List[threading.Thread] = []

    # ------------------------------------------------------------------
    # Camera ingestion (transport adapters call these)
    # ------------------------------------------------------------------
    def push_color(self, camera: str, seq: int, rgb: np.ndarray) -> None:
        self._camera_map[camera].push_color(seq, rgb)

    def push_depth(self, camera: str, seq: int, depth: np.ndarray) -> None:
        self._camera_map[camera].push_depth(seq, depth)

    @property
    def cameras(self) -> Dict[str, CameraBuffer]:
        return self._camera_map

    # ------------------------------------------------------------------
    # Projector/order initialization (segmenter.cpp:144-243)
    # ------------------------------------------------------------------
    def initialize_projector(
        self,
        camera_order: Sequence[str],
        calibrations: Sequence[Calibration],
        image_size: Tuple[int, int],
    ) -> None:
        """Fix the camera order and start the worker threads.

        The reference derives order/extrinsics from the first map node plus
        tf lookups; here the embedding application supplies them directly.
        """
        h, w = image_size
        self._camera_h, self._camera_w = int(h), int(w)
        # Camera-size uniformity (segmenter.cpp:193-199): the reference
        # derives each camera's image size from its principal point
        # (2*cx, 2*cy) and requires all cameras to agree with the first.
        size_seen = None
        for calib in calibrations:
            cw = float(calib.intrinsic[0, 2]) * 2
            ch = float(calib.intrinsic[1, 2]) * 2
            if size_seen is None:
                size_seen = (cw, ch)
            elif size_seen != (cw, ch):
                raise RuntimeError(
                    "Cameras with different image sizes are not supported!"
                )
        with self._frame_lock:
            for name, calib in zip(camera_order, calibrations):
                if name not in self._camera_map:
                    raise RuntimeError(f"Unknown camera found in map node: {name}")
                cam = self._camera_map[name]
                cam.set_calibration(calib)
                self._cameras_in_order.append(cam)
                self._image_queues.append(deque())
                self._result_queues.append(deque())
            # Drop cameras that are not part of the ordered set (:207-222).
            used = {c.name for c in self._cameras_in_order}
            for name in list(self._camera_map):
                if name not in used:
                    log.info("Not using camera %s", name)
                    del self._camera_map[name]

        self._projector = MultiProjector.from_calibrations(
            calibrations, h, w, min_distance=self.depth_min
        )
        if self._forest is not None:
            self._frame_pipeline = SingleFramePipeline(
                self.feature_config,
                self._forest,
                stride=self.rf_prediction_stride,
                fill_value=0.0,  # online node init (segmenter.cpp:358-362)
            )
        self._map_pipeline = LocalMapPipeline(
            self._projector,
            self.layer_class_counts,
            self.layer_unknown_labels,
            self.crf_params,
        )
        self._order_initialized = True

        for target in (self._frame_worker, self._map_worker):
            t = threading.Thread(target=target, daemon=True)
            t.start()
            self._threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=5.0)

    # ------------------------------------------------------------------
    # SLAM-side callbacks (segmenter.cpp:245-304)
    # ------------------------------------------------------------------
    def on_new_node(
        self,
        node: MapNode,
        camera_order: Optional[Sequence[str]] = None,
        calibrations: Optional[Sequence[Calibration]] = None,
        image_size: Optional[Tuple[int, int]] = None,
    ) -> bool:
        """Handle a keyframe; returns True if it was queued for inference."""
        if node.node_id <= self._last_key_frame_id and self._last_key_frame_id:
            return False  # filter old messages (:250)
        self._last_key_frame_id = node.node_id
        if not self._order_initialized:
            if camera_order is None:
                raise RuntimeError(
                    "initialize_projector must run (or pass camera_order) "
                    "before the first map node"
                )
            self.initialize_projector(camera_order, calibrations, image_size)

        # Keyframe gate (:257-265).
        pose = np.asarray(node.pose, dtype=np.float32)
        delta = np.linalg.inv(self._last_pose) @ pose
        if (
            np.linalg.norm(delta[:3, 3]) < self.keyframe_skip_translation
            and abs(rotation_angle(delta)) < self.keyframe_skip_rotation
        ):
            log.info("skipping keyframe")
            return False

        with self._frame_lock:
            self._last_pose = pose
            for i, seq in enumerate(node.subimage_seqs):
                got = self._cameras_in_order[i].get_id_and_clear(seq)
                if got is None:
                    raise RuntimeError(
                        f"Requested old missing frame for camera {i}!"
                    )
                (color_seq, rgb), (depth_seq, depth) = got
                # Depth must match; color may trail by < 3 (:278-287).
                if depth_seq == seq and depth_seq - color_seq < 3:
                    self._image_queues[i].append((depth_seq, depth, rgb))
                else:
                    log.error(
                        "Dropped a frame for camera %d! Semantics won't be "
                        "computed for depth seq: %d", i, seq,
                    )
        return True

    def on_new_local_map(self, lmap: LocalMapData) -> None:
        with self._cloud_processing_lock:
            self._local_map_queue.append(lmap)

    # ------------------------------------------------------------------
    # Worker A: per-frame inference (segmenter.cpp:323-514)
    # ------------------------------------------------------------------
    #: size ladder for opportunistic frame batching (powers of two keep
    #: the number of compiled batch variants tiny).
    _BATCH_LADDER = (8, 4, 2, 1)

    def _process_one_frame(self) -> bool:
        """Drain and segment queued frames; True if any were processed.

        When a camera queue has backlog, up to 8 frames ride ONE batched
        dispatch (DP over keyframes, SURVEY.md 2.5) — the serving analogue
        of the reference's one-frame-at-a-time worker loop
        (segmenter.cpp:323-443) that amortizes dispatch latency and fills
        the card when inference falls behind the camera rate.
        """
        for i, cam in enumerate(self._cameras_in_order):
            with self._frame_lock:
                if not self._image_queues[i]:
                    continue
                avail = len(self._image_queues[i])
                batch = 1
                if self._external is None:
                    batch = next(b for b in self._BATCH_LADDER if b <= avail)
                popped = [
                    self._image_queues[i].popleft() for _ in range(batch)
                ]
                calib = cam.calibration
            if self._external is not None:
                (seq, depth, rgb) = popped[0]
                posteriors = [self._external_frame(rgb, depth, calib)]
                seqs = [seq]
            elif batch == 1:
                (seq, depth, rgb) = popped[0]
                result = self._frame_pipeline.run(rgb, depth, calib)
                # Keep posteriors on device: the fusion stage consumes them
                # there (accumulate_unaries); pulling ~20MB per frame to the
                # host would waste PCIe bandwidth.
                posteriors = [list(result.posteriors)]
                seqs = [seq]
            else:
                seqs = [p[0] for p in popped]
                results = self._frame_pipeline.run_batch(
                    [p[2] for p in popped],
                    [p[1] for p in popped],
                    [calib] * batch,
                )
                posteriors = [list(r.posteriors) for r in results]
            with self._frame_lock:
                for seq, post in zip(seqs, posteriors):
                    self._result_queues[i].append((seq, post))
            return True
        return False

    def _external_frame(
        self, rgb: np.ndarray, depth: np.ndarray, calib: Calibration
    ) -> List[np.ndarray]:
        """External path: rectify depth to world xyz, call the hook
        (segmenter.cpp:446-514)."""
        import jax.numpy as jnp

        from ..ops.geometry import backproject

        depth3d = np.asarray(
            backproject(
                jnp.asarray(depth),
                jnp.asarray(calib.intrinsic_inverse),
                jnp.asarray(calib.rotation),
                jnp.asarray(calib.translation),
                np.float32(self.depth_min),
                np.float32(self.depth_max),
            )
        )
        dist = self._external(rgb, depth3d)
        return [np.asarray(p, dtype=np.float32) for p in dist]

    def _frame_worker(self) -> None:
        while not self._stop.is_set():
            if not self._process_one_frame():
                time.sleep(0.001)

    # ------------------------------------------------------------------
    # Worker B: map fusion (segmenter.cpp:518-719)
    # ------------------------------------------------------------------
    def _try_process_map(self) -> bool:
        with self._cloud_processing_lock:
            if not self._local_map_queue:
                return False
            lmap = self._local_map_queue[0]
            last_ids = lmap.nodes[-1].subimage_seqs if lmap.nodes else []
            with self._frame_lock:
                complete = all(
                    self._result_queues[i]
                    and self._result_queues[i][-1][0] >= last_ids[i]
                    for i in range(len(last_ids))
                )
            if not complete:
                return False  # postpone (:548-553)
            self._local_map_queue.popleft()

        nodes: List[MapNodeFrames] = []
        for node in lmap.nodes:
            frame_posteriors: List[Optional[List[np.ndarray]]] = []
            with self._frame_lock:
                for i, seq in enumerate(node.subimage_seqs):
                    q = self._result_queues[i]
                    while q and q[0][0] < seq:  # drop skipped (:589-591)
                        q.popleft()
                    if q and q[0][0] == seq:
                        flat = q.popleft()[1]
                        frame_posteriors.append(flat)
                    else:
                        log.error(
                            "Couldn't find a semantic map for key frame: %d", seq
                        )
                        frame_posteriors.append(None)
            nodes.append(MapNodeFrames(pose=node.pose, posteriors=frame_posteriors))

        labels = self._map_pipeline.run(
            lmap.cloud_points, lmap.cloud_rgb, nodes
        )
        if self._dump:
            self._dump_cloud(lmap, labels)
        with self._cloud_lock:
            self._cloud_results.append((lmap.map_id, labels))
        return True

    def _map_worker(self) -> None:
        while not self._stop.is_set():
            if not self._try_process_map():
                time.sleep(0.001)

    def _dump_cloud(self, lmap: LocalMapData, labels: List[np.ndarray]) -> None:
        """Debug dumps (segmenter.cpp:684-706): raw + per-layer colorized."""
        base = os.path.join(self._dump_dir, f"cloud{lmap.map_id}")
        np.savez(
            base + "_rgb.npz", points=lmap.cloud_points, rgb=lmap.cloud_rgb
        )
        for li, layer in enumerate(self.layers):
            colors = np.array(layer.class_colors, dtype=np.uint8)
            np.savez(
                base + f"_layer_{li}.npz",
                points=lmap.cloud_points,
                rgb=colors[labels[li]] / 255.0,
                labels=labels[li],
            )

    # ------------------------------------------------------------------
    # Synchronous draining (for tests / batch use without threads)
    # ------------------------------------------------------------------
    def drain(self, timeout: float = 60.0) -> None:
        """Process queued frames and maps inline until empty."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            progress = self._process_one_frame()
            progress |= self._try_process_map()
            with self._frame_lock, self._cloud_processing_lock:
                empty = (
                    all(not q for q in self._image_queues)
                    and not self._local_map_queue
                )
            if empty and not progress:
                return
        raise TimeoutError("drain did not finish in time")

    # ------------------------------------------------------------------
    # Services (segmenter.cpp:722-792, srv/*.srv)
    # ------------------------------------------------------------------
    def stored_semantics_ids(self) -> List[int]:
        """IdsSrv (:722-729)."""
        with self._cloud_lock:
            return [m_id for m_id, _ in self._cloud_results]

    def get_local_map_segmentation(
        self, local_map_id: int, segmentation_layers: Sequence[str]
    ) -> Optional[Tuple[int, List[int]]]:
        """LocalMapSegmentationSrv (:731-774): flattened per-layer labels."""
        layer_indices = [
            i
            for name in segmentation_layers
            for i, ln in enumerate(self.layer_names)
            if name == ln
        ]
        if len(layer_indices) != len(segmentation_layers):
            return None
        with self._cloud_lock:
            for m_id, labels in self._cloud_results:
                if m_id == local_map_id:
                    flat: List[int] = []
                    for l in layer_indices:
                        flat.extend(int(v) for v in labels[l])
                    return m_id, flat
        return None

    def segmentation_information(self) -> Dict[str, list]:
        """SegmentationInformationSrv (:776-792)."""
        class_names: List[str] = []
        class_colors: List[int] = []
        for layer in self.layers:
            class_names.extend(layer.class_names)
            for c in layer.class_colors:
                class_colors.extend(int(v) for v in c)
        return {
            "layer_names": list(self.layer_names),
            "class_counts": list(self.layer_class_counts),
            "class_names": class_names,
            "class_colors": class_colors,
        }

"""Serve-layer tests: segmenter runtime, queue semantics, HTTP services."""

import json
import urllib.request

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from rovinasemanticsegmentation_tpu.models.forest import random_forest
from rovinasemanticsegmentation_tpu.serve.camera import (
    CameraBuffer,
    parse_name_from_topic,
)
from rovinasemanticsegmentation_tpu.serve.segmenter import (
    LocalMapData,
    MapNode,
    Segmenter,
)
from rovinasemanticsegmentation_tpu.serve.services import (
    SegmentationServiceServer,
    heuristic_single_frame_segmentation,
)
from rovinasemanticsegmentation_tpu.utils.calibration import Calibration
from rovinasemanticsegmentation_tpu.utils.config import Config

H, W = 24, 32

CONFIG = {
    "root_dir": "",
    "color_codings": [
        {
            "name": "material",
            "coding": [
                {"name": "A", "color": [255, 0, 0], "label": 0},
                {"name": "B", "color": [0, 255, 0], "label": 1},
                {"name": "Unknown", "color": [50, 50, 50], "label": 2},
                {"name": "Void", "color": [0, 0, 0], "label": -1},
            ],
        },
        {
            "name": "object",
            "coding": [
                {"name": "X", "color": [255, 0, 0], "label": 0},
                {"name": "Y", "color": [0, 255, 0], "label": 1},
                {"name": "Z", "color": [0, 0, 255], "label": 2},
                {"name": "Unknown", "color": [50, 50, 50], "label": 3},
                {"name": "Void", "color": [0, 0, 0], "label": -1},
            ],
        },
    ],
    "use_dense_crf": False,
    "dcrf_xyz_kernel": 0.5,
    "dcrf_rgb_kernel": 4.0,
    "dcrf_kernel_weight": 10.0,
    "dcrf_iterations": 10,
    "rf_prediction_stride": 2,
    "depth_min": 0.5,
    "depth_max": 15.0,
    "keyframe_skip_rotation": 0.1,
    "keyframe_skip_translation": 0.07,
    "patch_size": 15,
    "patch_size_reduce": 5,
    "feature_color_patch": True,
    "feature_depth": True,
    "feature_height": True,
    "feature_normal": True,
}


def make_calib():
    return Calibration(
        intrinsic=np.array([[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]]),
        rotation=np.eye(3),
        translation=np.zeros(3),
    )


def make_segmenter(**kwargs):
    rng = np.random.default_rng(0)
    forest = random_forest(
        rng, num_trees=2, depth=5, num_features=78,
        class_counts=[3, 4], max_nodes=31,
    )
    return Segmenter(
        Config(data=CONFIG),
        topic_names=["/camera_front/rgb/image", "/camera_front/depth/image"],
        forest=forest,
        **kwargs,
    )


def push_frame(seg, seq, seed=0):
    rng = np.random.default_rng(seed)
    rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
    depth = rng.integers(600, 9000, (H, W)).astype(np.uint16)
    seg.push_color("camera_front", seq, rgb)
    seg.push_depth("camera_front", seq, depth)


def pose_at(x):
    p = np.eye(4, dtype=np.float32)
    p[0, 3] = x
    return p


class TestCameraBuffer:
    def test_topic_parsing(self):
        assert parse_name_from_topic("/camera_front/rgb/image") == "camera_front"
        # Short first segment: take two segments (xtion.cpp:164-169).
        assert parse_name_from_topic("/ban/camera_x/rgb") == "ban/camera_x"

    def test_pairing_errors(self):
        cam = CameraBuffer("c")
        cam.add_topic("/c/rgb")
        with pytest.raises(RuntimeError):
            cam.add_topic("/c/color")  # duplicate color
        with pytest.raises(RuntimeError):
            cam.add_topic("/c/bogus")  # neither rgb nor depth
        cam.add_topic("/c/depth")
        assert cam.is_complete

    def test_get_id_and_clear_semantics(self):
        cam = CameraBuffer("c")
        for seq in (1, 2, 3, 4):
            cam.push_color(seq, np.zeros(1))
            cam.push_depth(seq, np.ones(1))
        (cs, _), (ds, _) = cam.get_id_and_clear(2)
        assert cs == 2 and ds == 2
        # Frames 1 dropped; requesting an old id returns None.
        assert cam.get_id_and_clear(1) is None
        # Future id raises (xtion.cpp:137-138).
        with pytest.raises(RuntimeError):
            cam.get_id_and_clear(99)


class TestSegmenterRuntime:
    def test_end_to_end_map(self, tmp_path):
        seg = make_segmenter(dump_clouds_to_tmp=True, dump_dir=str(tmp_path))
        seg.initialize_projector(["camera_front"], [make_calib()], (H, W))
        seg.stop()  # run synchronously via drain()

        push_frame(seg, 1)
        assert seg.on_new_node(MapNode(1, pose_at(0.0), [1]))

        rng = np.random.default_rng(1)
        n = 40
        pts = np.stack(
            [rng.uniform(-0.4, 0.4, n), rng.uniform(-0.3, 0.3, n), np.full(n, 2.0)],
            axis=1,
        ).astype(np.float32)
        seg.on_new_local_map(
            LocalMapData(7, [MapNode(1, pose_at(0.0), [1])], pts,
                         rng.uniform(0, 1, (n, 3)).astype(np.float32))
        )
        seg.drain()

        assert seg.stored_semantics_ids() == [7]
        got = seg.get_local_map_segmentation(7, ["material", "object"])
        assert got is not None
        map_id, labels = got
        assert map_id == 7
        assert len(labels) == 2 * n
        info = seg.segmentation_information()
        assert info["layer_names"] == ["material", "object"]
        assert info["class_counts"] == [3, 4]
        assert len(info["class_names"]) == 7
        assert len(info["class_colors"]) == 21
        # Debug dumps written.
        assert (tmp_path / "cloud7_rgb.npz").exists()
        assert (tmp_path / "cloud7_layer_0.npz").exists()

    @pytest.mark.slow  # batch==per-frame parity stays fast in test_batch_matches_per_frame
    def test_batched_frame_worker_matches_single(self):
        """Backlogged queues ride run_batch; results identical per frame."""

        def build(batched):
            seg = make_segmenter()
            seg.initialize_projector(["camera_front"], [make_calib()], (H, W))
            seg.stop()
            for s in range(1, 5):
                push_frame(seg, s, seed=s)
                assert seg.on_new_node(MapNode(s, pose_at(0.2 * s), [s]))
                if not batched:  # one frame in the queue: one per dispatch
                    assert seg._process_one_frame()
            # Drain: the batched build takes one 4-frame dispatch.
            while seg._process_one_frame():
                pass
            return [
                (seq, [np.asarray(p) for p in post])
                for seq, post in seg._result_queues[0]
            ]

        single = build(False)
        batched = build(True)
        assert [s for s, _ in batched] == [s for s, _ in single]
        for (_, a), (_, b) in zip(batched, single):
            for pa, pb in zip(a, b):
                np.testing.assert_allclose(pa, pb, rtol=1e-4, atol=1e-5)

    def test_keyframe_gating(self):
        seg = make_segmenter()
        seg.initialize_projector(["camera_front"], [make_calib()], (H, W))
        seg.stop()
        push_frame(seg, 1)
        assert seg.on_new_node(MapNode(1, pose_at(0.0), [1]))
        # Tiny motion: skipped, frames not consumed.
        push_frame(seg, 2)
        assert not seg.on_new_node(MapNode(2, pose_at(0.05), [2]))
        # Large motion: accepted.
        assert seg.on_new_node(MapNode(3, pose_at(0.5), [2]))

    def test_stale_node_id_filtered(self):
        seg = make_segmenter()
        seg.initialize_projector(["camera_front"], [make_calib()], (H, W))
        seg.stop()
        push_frame(seg, 1)
        assert seg.on_new_node(MapNode(5, pose_at(0.0), [1]))
        assert not seg.on_new_node(MapNode(4, pose_at(9.9), [1]))

    def test_missing_depth_seq_dropped(self):
        seg = make_segmenter()
        seg.initialize_projector(["camera_front"], [make_calib()], (H, W))
        seg.stop()
        rng = np.random.default_rng(0)
        # Depth seq 4 was lost in transport; color has everything. The node
        # requesting seq 4 gets depth seq 5 != 4 -> frame dropped
        # (segmenter.cpp:278-287).
        for s in (1, 2, 3, 4, 5):
            seg.push_color("camera_front", s,
                           rng.integers(0, 255, (H, W, 3), dtype=np.uint8))
        for s in (1, 2, 3, 5):
            seg.push_depth("camera_front", s,
                           rng.integers(600, 9000, (H, W)).astype(np.uint16))
        assert seg.on_new_node(MapNode(1, pose_at(0.0), [4]))
        with seg._frame_lock:
            assert len(seg._image_queues[0]) == 0  # dropped, not queued

    def test_unavailable_id_raises(self):
        # Requesting a seq newer than anything buffered is a hard error
        # (xtion.cpp:137-138).
        seg = make_segmenter()
        seg.initialize_projector(["camera_front"], [make_calib()], (H, W))
        seg.stop()
        push_frame(seg, 1)
        with pytest.raises(RuntimeError):
            seg.on_new_node(MapNode(1, pose_at(0.0), [9]))

    def test_missing_result_tolerated_in_fusion(self):
        seg = make_segmenter()
        seg.initialize_projector(["camera_front"], [make_calib()], (H, W))
        seg.stop()
        push_frame(seg, 2)
        assert seg.on_new_node(MapNode(1, pose_at(0.0), [2]))
        rng = np.random.default_rng(2)
        pts = np.zeros((5, 3), dtype=np.float32)
        pts[:, 2] = 2.0
        # The map's node asks for seq 1, which was never produced; queue has
        # seq 2 >= 1 so fusion proceeds with a missing frame.
        seg.on_new_local_map(
            LocalMapData(1, [MapNode(1, pose_at(0.0), [1])], pts,
                         rng.uniform(0, 1, (5, 3)).astype(np.float32))
        )
        seg.drain()
        ids = seg.stored_semantics_ids()
        assert ids == [1]
        _, labels = seg.get_local_map_segmentation(1, ["material"])
        assert all(l == 2 for l in labels)  # all Unknown


class TestServices:
    def test_http_services(self):
        seg = make_segmenter()
        seg.initialize_projector(["camera_front"], [make_calib()], (H, W))
        seg.stop()
        server = SegmentationServiceServer(seg)
        server.start()
        try:
            base = server.address
            with urllib.request.urlopen(base + "/semantic_segmentation/local_map_ids") as r:
                assert json.load(r)["local_map_ids"] == []
            with urllib.request.urlopen(base + "/semantic_segmentation/information") as r:
                info = json.load(r)
            assert info["layer_names"] == ["material", "object"]

            req = urllib.request.Request(
                base + "/semantic_segmentation/get_local_map_segmentation",
                data=json.dumps(
                    {"local_map_id": 0, "segmentation_layers": ["nope"]}
                ).encode(),
                method="POST",
            )
            with pytest.raises(urllib.error.HTTPError) as exc:
                urllib.request.urlopen(req)
            assert exc.value.code == 404
        finally:
            server.stop()

    def test_heuristic_stub(self):
        depth3d = np.zeros((4, 4, 3), dtype=np.float32)
        depth3d[0, :, 2] = 0.2  # floor
        depth3d[1, :, 2] = 1.0  # wall
        depth3d[2, :, 2] = 2.0  # ceiling
        rgb = np.zeros((4, 4, 3), dtype=np.uint8)
        out = heuristic_single_frame_segmentation(rgb, depth3d, [3, 4])
        assert len(out) == 2 and out[0].shape == (4, 4, 3)
        np.testing.assert_allclose(out[0][0, 0], [1, 0, 0])
        np.testing.assert_allclose(out[0][1, 0], [0, 1, 0])
        np.testing.assert_allclose(out[0][2, 0], [0, 0, 1])
        np.testing.assert_allclose(out[0][3, 0], [1 / 3, 1 / 3, 1 / 3])
        np.testing.assert_allclose(out[1][3, 0, :3], 1 / 3)


class TestExternalPath:
    def test_external_segmentation_hook(self):
        seg = make_segmenter()
        # Rebuild with an external hook instead of the forest.
        ext = Segmenter(
            Config(data=CONFIG),
            topic_names=["/camera_front/rgb/i", "/camera_front/depth/i"],
            external_segmentation=lambda rgb, depth3d:
                heuristic_single_frame_segmentation(rgb, depth3d, [3, 4]),
        )
        ext.initialize_projector(["camera_front"], [make_calib()], (H, W))
        ext.stop()
        rng = np.random.default_rng(3)
        rgb = rng.integers(0, 255, (H, W, 3), dtype=np.uint8)
        depth = np.full((H, W), 2000, dtype=np.uint16)
        ext.push_color("camera_front", 1, rgb)
        ext.push_depth("camera_front", 1, depth)
        assert ext.on_new_node(MapNode(1, pose_at(0.0), [1]))
        pts = np.zeros((5, 3), dtype=np.float32)
        pts[:, 2] = 2.0
        ext.on_new_local_map(
            LocalMapData(3, [MapNode(1, pose_at(0.0), [1])], pts,
                         np.ones((5, 3), dtype=np.float32) * 0.5)
        )
        ext.drain()
        assert ext.stored_semantics_ids() == [3]


class TestThreeCameraRig:
    """The reference deployment: three Xtions stacked into one projector
    image (launch/semantics.launch declares 3 color+depth topic pairs)."""

    def test_three_camera_fusion(self):
        rng = np.random.default_rng(0)
        forest = random_forest(
            rng, num_trees=2, depth=5, num_features=78,
            class_counts=[3, 4], max_nodes=31,
        )
        topics = []
        for cam in ("camera_front", "camera_left", "camera_right"):
            topics += [f"/{cam}/rgb/image", f"/{cam}/depth/image"]
        seg = Segmenter(Config(data=CONFIG), topic_names=topics, forest=forest)
        rots = {
            "camera_front": np.eye(3),
            # left/right cameras rotated +-90 deg about y.
            "camera_left": np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], float),
            "camera_right": np.array([[0, 0, -1], [0, 1, 0], [1, 0, 0]], float),
        }
        order = ["camera_front", "camera_left", "camera_right"]
        calibs = [
            Calibration(
                intrinsic=np.array(
                    [[20.0, 0, W / 2], [0, 20.0, H / 2], [0, 0, 1]]
                ),
                rotation=rots[name],
                translation=np.zeros(3),
            )
            for name in order
        ]
        seg.initialize_projector(order, calibs, (H, W))
        seg.stop()

        for name in order:
            rgb = rng.integers(0, 256, (H, W, 3), dtype=np.uint8)
            depth = rng.integers(600, 9000, (H, W)).astype(np.uint16)
            seg.push_color(name, 1, rgb)
            seg.push_depth(name, 1, depth)
        assert seg.on_new_node(MapNode(1, np.eye(4), [1, 1, 1]))

        # Points in front (+z), left (-x) and right (+x) of the rig: each
        # visible to exactly one camera.
        pts = np.array(
            [[0, 0, 2.0], [-2.0, 0, 0], [2.0, 0, 0]], dtype=np.float32
        )
        seg.on_new_local_map(
            LocalMapData(11, [MapNode(1, np.eye(4), [1, 1, 1])], pts,
                         np.full((3, 3), 0.5, np.float32))
        )
        seg.drain()
        assert seg.stored_semantics_ids() == [11]
        _, labels = seg.get_local_map_segmentation(11, ["material"])
        # Every point was observed by some camera: no all-zero unaries, so
        # labels are valid class indices.
        assert len(labels) == 3
        assert all(0 <= l < 3 for l in labels)

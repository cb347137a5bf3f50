"""Tests for core utils: config, labels, calibration, binary IO, metrics."""

import json
import math
import os

import numpy as np
import pytest

from rovinasemanticsegmentation_tpu.utils import (
    Calibration,
    Config,
    KeyNotFoundException,
    RgbLabelConversion,
    parse_color_codings,
)
from rovinasemanticsegmentation_tpu.utils.config import (
    load_config_from_argv,
    parse_cli_overrides,
)
from rovinasemanticsegmentation_tpu.utils.cvio import (
    read_mat,
    rgb_to_segment_id,
    save_mat,
    segment_id_to_rgb,
)
from rovinasemanticsegmentation_tpu.utils.metrics import ConfusionAccumulator

MATERIAL_CODING = [
    {"name": "Marble", "color": [255, 0, 255], "label": 0},
    {"name": "New bricks", "color": [0, 255, 0], "label": 1},
    {"name": "Unknown", "color": [50, 50, 50], "label": 2},
    {"name": "Other", "color": [255, 255, 255], "label": -2},
    {"name": "Void", "color": [0, 0, 0], "label": -1},
]


class TestConfig:
    def test_basic_get_and_overrides(self, tmp_path):
        cfg_file = tmp_path / "conf.json"
        cfg_file.write_text(
            json.dumps({"root_dir": str(tmp_path), "num_trees": 4, "w": 1.5})
        )
        conf = Config(str(cfg_file), {"num_trees": "8", "extra": "[1, 2]"})
        assert conf.get_int("num_trees") == 8  # override parsed as JSON
        assert conf.get_float("w") == 1.5
        assert conf.get_list("extra") == [1, 2]
        with pytest.raises(KeyNotFoundException):
            conf.get("missing")
        assert conf.get("missing", 7) == 7

    def test_get_path_and_from_file(self, tmp_path):
        split = tmp_path / "split.json"
        split.write_text(json.dumps(["a", "b"]))
        cfg_file = tmp_path / "conf.json"
        cfg_file.write_text(
            json.dumps({"root_dir": str(tmp_path), "file_names_train": "split.json"})
        )
        conf = Config(str(cfg_file))
        assert conf.get_path("file_names_train") == str(split)
        assert conf.get_from_file("file_names_train") == ["a", "b"]

    def test_cli_parsing(self, tmp_path):
        cfg_file = tmp_path / "conf.json"
        cfg_file.write_text(json.dumps({"root_dir": "", "a": 1}))
        conf, _ = load_config_from_argv(["--conf", str(cfg_file), "--a", "2"])
        assert conf.get_int("a") == 2
        with pytest.raises(ValueError):
            parse_cli_overrides(["--a"])  # odd count
        with pytest.raises(ValueError):
            parse_cli_overrides(["a", "1"])  # missing --


class TestLabels:
    def test_roundtrip(self):
        conv = RgbLabelConversion(json.dumps(MATERIAL_CODING))
        labels = np.array([[0, 1], [2, -2], [-1, 0]], dtype=np.int8)
        rgb = conv.label_to_rgb(labels)
        assert rgb.shape == (3, 2, 3)
        back = conv.rgb_to_label(rgb)
        np.testing.assert_array_equal(back, labels)

    def test_unmapped_color_is_zero(self):
        # std::map::operator[] default-construction semantics
        # (rgb_label_conversion.h:86-88).
        conv = RgbLabelConversion(MATERIAL_CODING)
        rgb = np.full((2, 2, 3), 123, dtype=np.uint8)
        np.testing.assert_array_equal(conv.rgb_to_label(rgb), np.zeros((2, 2)))

    def test_counts_and_names(self):
        conv = RgbLabelConversion(MATERIAL_CODING)
        assert conv.label_count == 5
        assert conv.valid_label_count == 3
        assert conv.get_label_name(1) == "New bricks"
        assert conv.get_label_number("Void") == -1

    def test_layer_coding(self):
        layers = parse_color_codings(
            [{"name": "material", "coding": MATERIAL_CODING}]
        )
        layer = layers[0]
        assert layer.name == "material"
        assert layer.class_count == 3
        assert layer.class_names == ["Marble", "New bricks", "Unknown"]
        assert layer.unknown_label == 2
        assert layer.class_colors[0] == (255, 0, 255)


class TestCalibration:
    def test_r3_roundtrip(self, tmp_path):
        theta = 0.3
        rot = np.array(
            [
                [math.cos(theta), -math.sin(theta), 0],
                [math.sin(theta), math.cos(theta), 0],
                [0, 0, 1],
            ],
            dtype=np.float32,
        )
        calib = Calibration(
            intrinsic=np.array([[525, 0, 320], [0, 525, 240], [0, 0, 1]]),
            rotation=rot,
            translation=np.array([0.1, 0.2, 0.3]),
        )
        path = str(tmp_path / "calib.json")
        calib.save_to_file(path)
        loaded = Calibration(filename=path)
        np.testing.assert_allclose(loaded.intrinsic, calib.intrinsic, rtol=1e-6)
        np.testing.assert_allclose(loaded.rotation, rot, rtol=1e-6)
        np.testing.assert_allclose(loaded.translation, calib.translation, rtol=1e-6)

    def test_quaternion_formats(self, tmp_path):
        # 90 degrees about z: q = (0, 0, sin(45), cos(45))
        s = math.sin(math.pi / 4)
        c = math.cos(math.pi / 4)
        base = {
            "intrinsic": [525, 0, 320, 0, 525, 240, 0, 0, 1],
            "translation": [1, 2, 3],
        }
        q4 = dict(base, rotation={"format": "q4", "data": [0, 0, s, c]})
        q3 = dict(base, rotation={"format": "q3", "data": [0, 0, s]})
        expected = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float32)
        for payload in (q4, q3):
            p = tmp_path / "c.json"
            p.write_text(json.dumps(payload))
            calib = Calibration(filename=str(p))
            np.testing.assert_allclose(calib.rotation, expected, atol=1e-6)
        assert calib.intrinsic[0, 2] == 320  # row-major layout

    def test_intrinsic_inverse(self):
        calib = Calibration(
            intrinsic=np.array([[525, 0, 320], [0, 525, 240], [0, 0, 1]])
        )
        np.testing.assert_allclose(
            calib.intrinsic @ calib.intrinsic_inverse, np.eye(3), atol=1e-5
        )


class TestCvio:
    def test_save_read_roundtrip(self, tmp_path):
        for arr in (
            np.random.randint(0, 65535, (5, 7), dtype=np.uint16),
            np.random.rand(4, 6, 3).astype(np.float32),
            np.random.randint(-128, 127, (3, 3), dtype=np.int8),
        ):
            path = str(tmp_path / "m.bin")
            save_mat(path, arr)
            out = read_mat(path)
            np.testing.assert_array_equal(out, arr)
            assert out.dtype == arr.dtype

    def test_reference_binary_layout(self, tmp_path):
        # CV_16UC1 = type 2: depth 2, channels 1.
        arr = np.arange(6, dtype=np.uint16).reshape(2, 3)
        path = str(tmp_path / "m.bin")
        save_mat(path, arr)
        raw = open(path, "rb").read()
        import struct

        cols, rows, chan, esiz, cv_type = struct.unpack("<5i", raw[:20])
        assert (cols, rows, chan, esiz, cv_type) == (3, 2, 1, 2, 2)

    def test_segment_id_codec(self):
        ids = np.array([[0, 1, 2], [255, 4095, (1 << 24) - 1]], dtype=np.int32)
        rgb = segment_id_to_rgb(ids)
        np.testing.assert_array_equal(rgb_to_segment_id(rgb), ids)
        # id 1 -> bit 0 -> R channel bit 7 (cv_util.cpp:97-105).
        assert tuple(rgb[0, 1]) == (128, 0, 0)


class TestMetrics:
    def test_perfect_prediction(self):
        acc = ConfusionAccumulator(3)
        gt = np.array([0, 1, 2, 2, 1])
        acc.update(gt, gt)
        assert acc.global_accuracy() == 100.0
        assert acc.class_average_accuracy() == 100.0
        assert acc.mean_iou() == 100.0

    def test_negative_labels_ignored(self):
        acc = ConfusionAccumulator(2)
        acc.update(np.array([0, -1, 1]), np.array([0, 0, -5]))
        assert acc.total == 1
        assert acc.global_accuracy() == 100.0

    def test_known_confusion(self):
        acc = ConfusionAccumulator(2)
        # gt: 0 0 1 1; pred: 0 1 1 1
        acc.update(np.array([0, 1, 1, 1]), np.array([0, 0, 1, 1]))
        np.testing.assert_array_equal(acc.confusion, [[1, 1], [0, 2]])
        assert acc.global_accuracy() == 75.0
        assert acc.class_average_accuracy() == 75.0
        # IoU class0 = 1/(2+1-1)=0.5; class1 = 2/(2+3-2)=2/3
        assert acc.mean_iou() == pytest.approx(100 * (0.5 + 2 / 3) / 2)
        report = acc.report(["a", "b"])
        assert "Global accuracy" in report and "Intersection over union" in report


class TestDebugViz:
    def test_heatmap_and_gray(self, tmp_path):
        from rovinasemanticsegmentation_tpu.utils.cvio import save_gray, save_heatmap
        from rovinasemanticsegmentation_tpu.utils.imageio import load_color

        data = np.linspace(0, 1, 12).reshape(3, 4)
        hp = str(tmp_path / "h.png")
        gp = str(tmp_path / "g.png")
        save_heatmap(hp, data)
        save_gray(gp, data)
        h = load_color(hp)
        g = load_color(gp)
        assert h.shape == (3, 4, 3) and g.shape == (3, 4, 3)
        # Jet: low -> blue-ish, high -> red-ish.
        assert h[0, 0, 2] > h[0, 0, 0]
        assert h[2, 3, 0] > h[2, 3, 2]
        assert g[0, 0, 0] == 0 and g[2, 3, 0] == 255


class TestSyntheticCloud:
    """utils/synthetic.make_cloud: map points lie on the keyframes'
    surfaces and reproject to pixel centres, never onto the pixel edges
    where the projector's int() truncation would be a rounding tie."""

    @pytest.mark.parametrize("seed", [0, 1])
    def test_points_reproject_to_pixel_centres(self, seed):
        from rovinasemanticsegmentation_tpu.utils.synthetic import (
            FOCAL,
            make_cloud,
            make_frames,
        )

        rng = np.random.default_rng(seed)
        frames = make_frames(rng, 2, 96, 128)
        offsets = [np.array([0.1 * f, 0.0, 0.0]) for f in range(2)]
        pts, rgb = make_cloud(rng, frames, 100, offsets=offsets)
        assert pts.shape == (100, 3) and rgb.shape == (100, 3)
        assert rgb.min() >= 0.0 and rgb.max() <= 1.0
        for f, sl in enumerate((slice(0, 50), slice(50, 100))):
            cam = pts[sl].astype(np.float64) - offsets[f]
            u = FOCAL * cam[:, 0] / cam[:, 2] + 64
            v = FOCAL * cam[:, 1] / cam[:, 2] + 48
            for c in (u, v):
                np.testing.assert_allclose(c - np.floor(c), 0.5, atol=1e-3)

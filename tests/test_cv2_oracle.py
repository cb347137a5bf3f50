"""Golden-oracle tests against REAL OpenCV (VERDICT round-1 item #2).

The reference calls ``cv::cvtColor(color, CV_BGR2Lab)`` on 8-bit images
(``/root/reference/include/feature_extractor.h:129``) and
``cv::resize(..., INTER_LINEAR)`` both for uint8 patch reduction
(``feature_extractor.h:142``) and float posterior upsampling
(``src/test_multi.cpp:199``). OpenCV is importable in this environment, so
these are true golden oracles — not hand-ported ones. Guarantees locked
in: rgb_to_lab8 BIT-EXACT vs cv2 (the round-1 float path was off by up to
2 LSB and was replaced with OpenCV's fixed-point table pipeline), float
resize exact, uint8 resize within 1 LSB (cv2's SIMD kernels truncate in a
different order than its scalar spec).
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")
jax = pytest.importorskip("jax")
import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.ops.color import rgb_to_lab8
from rovinasemanticsegmentation_tpu.ops.patches import (
    extract_patches_grid,
    reflect_pad_image,
)
from rovinasemanticsegmentation_tpu.ops.resize import (
    resize_bilinear,
    resize_bilinear_u8,
)


class TestLabVsOpenCV:
    def test_all_gray_levels(self):
        """Every (v,v,v) input, exhaustively."""
        img = np.repeat(np.arange(256, dtype=np.uint8)[:, None, None], 3, 2)
        got = np.asarray(rgb_to_lab8(jnp.asarray(img)))
        want = cv2.cvtColor(img, cv2.COLOR_BGR2Lab)
        np.testing.assert_array_equal(got, want)

    def test_random_images(self):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (64, 64, 3), dtype=np.uint8)
        got = np.asarray(rgb_to_lab8(jnp.asarray(img)))
        # The pipeline feeds RGB-ordered frames to BGR2Lab (the reference
        # quirk) — so the cv2 call gets the image as-is, unswapped.
        want = cv2.cvtColor(img, cv2.COLOR_BGR2Lab)
        np.testing.assert_array_equal(got, want)

    def test_true_rgb_mode(self):
        rng = np.random.default_rng(1)
        img = rng.integers(0, 256, (32, 32, 3), dtype=np.uint8)
        got = np.asarray(rgb_to_lab8(jnp.asarray(img), swap=False))
        want = cv2.cvtColor(img[..., ::-1].copy(), cv2.COLOR_BGR2Lab)
        np.testing.assert_array_equal(got, want)

    def test_extreme_values(self):
        corners = np.array(
            [[[0, 0, 0], [255, 255, 255], [255, 0, 0], [0, 255, 0],
              [0, 0, 255], [255, 255, 0], [0, 255, 255], [255, 0, 255]]],
            dtype=np.uint8,
        )
        got = np.asarray(rgb_to_lab8(jnp.asarray(corners)))
        want = cv2.cvtColor(corners, cv2.COLOR_BGR2Lab)
        np.testing.assert_array_equal(got, want)


class TestResizeVsOpenCV:
    def test_float_upsample_exact_cases(self):
        """Posterior-map upsample (test_multi.cpp:199): f32, stride 2."""
        rng = np.random.default_rng(2)
        for (h, w, oh, ow) in [(8, 10, 16, 20), (24, 32, 48, 64),
                               (5, 7, 13, 19), (12, 16, 24, 32)]:
            src = rng.normal(size=(h, w, 3)).astype(np.float32)
            got = np.asarray(resize_bilinear(jnp.asarray(src), oh, ow))
            want = cv2.resize(src, (ow, oh), interpolation=cv2.INTER_LINEAR)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_float_single_channel(self):
        rng = np.random.default_rng(3)
        src = rng.normal(size=(30, 40)).astype(np.float32)
        got = np.asarray(resize_bilinear(jnp.asarray(src), 60, 80))
        want = cv2.resize(src, (80, 60), interpolation=cv2.INTER_LINEAR)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_uint8_downsample_vs_cv2(self):
        """Patch reduction semantics (feature_extractor.h:142): uint8,
        arbitrary window -> 11x11. cv2's SIMD kernels may differ by 1 LSB."""
        rng = np.random.default_rng(4)
        worst = 0
        for w_src in [3, 5, 11, 23, 40, 77, 111, 155]:
            src = rng.integers(0, 256, (w_src, w_src, 3), dtype=np.uint8)
            got = np.asarray(resize_bilinear_u8(jnp.asarray(src), 11, 11))
            want = cv2.resize(src, (11, 11), interpolation=cv2.INTER_LINEAR)
            diff = np.abs(got.astype(int) - want.astype(int))
            worst = max(worst, int(diff.max()))
            assert diff.max() <= 1, f"window {w_src}: max diff {diff.max()}"
        assert worst <= 1

    def test_uint8_upsample(self):
        rng = np.random.default_rng(5)
        src = rng.integers(0, 256, (7, 9, 3), dtype=np.uint8)
        got = np.asarray(resize_bilinear_u8(jnp.asarray(src), 21, 27))
        want = cv2.resize(src, (27, 21), interpolation=cv2.INTER_LINEAR)
        assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


class TestPatchPipelineVsOpenCV:
    def test_depth_adaptive_patch_vs_cv2_crop_resize(self):
        """Full patch semantics: reflect-pad by B, crop (2h+1)^2 window,
        cv2-resize to RxR (feature_extractor.h:125-175), vs our kernel."""
        rng = np.random.default_rng(6)
        b, r, stride = 15, 5, 2
        h, w = 24, 32
        lab = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        depth = rng.uniform(0.6, 12.0, ( -(-h // stride), -(-w // stride))
                            ).astype(np.float32)
        padded = np.asarray(reflect_pad_image(jnp.asarray(lab), b))
        got = np.asarray(extract_patches_grid(
            jnp.asarray(padded), jnp.asarray(depth),
            patch_size=b, reduce_size=r, stride=stride))

        cv_pad = cv2.copyMakeBorder(lab, b, b, b, b, cv2.BORDER_REFLECT)
        np.testing.assert_array_equal(padded, cv_pad)

        gh, gw = depth.shape
        for gy in range(gh):
            for gx in range(gw):
                d = float(depth[gy, gx])
                half = int(np.floor(b / (2.0 * d)))
                half = min(half, b)
                y, x = gy * stride + b, gx * stride + b
                win = cv_pad[y - half : y + half + 1, x - half : x + half + 1]
                want = cv2.resize(win, (r, r),
                                  interpolation=cv2.INTER_LINEAR)
                diff = np.abs(got[gy, gx].astype(int) - want.astype(int))
                assert diff.max() <= 1, (
                    f"grid ({gy},{gx}) half={half}: max diff {diff.max()}"
                )

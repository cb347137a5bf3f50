"""Oracle tests for the feature-extraction ops."""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.ops.color import (
    adjust_brightness,
    hflip,
    rgb_to_lab8,
)
from rovinasemanticsegmentation_tpu.ops.geometry import backproject, depth_valid_mask
from rovinasemanticsegmentation_tpu.ops.normals import (
    normal_angles,
)
from rovinasemanticsegmentation_tpu.ops.patches import (
    extract_patches,
    reflect_pad_image,
)
from rovinasemanticsegmentation_tpu.ops.resize import (
    resize_bilinear,
    resize_bilinear_u8,
)


class TestLab:
    def test_gray_axis(self):
        # Any gray has a = b = 128 (neutral), regardless of channel swap.
        grays = np.stack([np.arange(256)] * 3, axis=-1).astype(np.uint8)[None]
        lab = np.asarray(rgb_to_lab8(jnp.asarray(grays)))
        np.testing.assert_array_equal(lab[..., 1], 128)
        np.testing.assert_array_equal(lab[..., 2], 128)
        # L monotone nondecreasing in the gray level; endpoints exact.
        assert lab[0, 0, 0] == 0 and lab[0, 255, 0] == 255
        assert (np.diff(lab[0, :, 0].astype(int)) >= 0).all()

    def test_known_values(self):
        # Independent float computation of CIE Lab (D65, sRGB gamma) for a
        # few colors, as OpenCV's 8U quantization L*255/100, a+128, b+128.
        def oracle(rgb, swap):
            c = np.array(rgb, dtype=np.float64) / 255.0
            if swap:
                b, g, r = c
            else:
                r, g, b = c
            lin = [
                x / 12.92 if x <= 0.04045 else ((x + 0.055) / 1.055) ** 2.4
                for x in (r, g, b)
            ]
            X = 0.412453 * lin[0] + 0.357580 * lin[1] + 0.180423 * lin[2]
            Y = 0.212671 * lin[0] + 0.715160 * lin[1] + 0.072169 * lin[2]
            Z = 0.019334 * lin[0] + 0.119193 * lin[1] + 0.950227 * lin[2]
            x, y, z = X / 0.950456, Y, Z / 1.088754

            def f(t):
                return t ** (1 / 3) if t > 0.008856 else 7.787 * t + 16 / 116

            L = 116 * f(y) - 16 if y > 0.008856 else 903.3 * y
            return (
                round(L * 255 / 100),
                round(500 * (f(x) - f(y)) + 128),
                round(200 * (f(y) - f(z)) + 128),
            )

        for color in [(255, 0, 0), (0, 255, 0), (0, 0, 255), (10, 200, 99)]:
            img = np.array([[color]], dtype=np.uint8)
            got = np.asarray(rgb_to_lab8(jnp.asarray(img)))[0, 0]
            want = oracle(color, swap=True)
            np.testing.assert_allclose(got.astype(int), want, atol=1)

    def test_swap_matches_reference_quirk(self):
        # The reference feeds RGB into BGR2Lab: red in = blue slot.
        red = np.array([[[255, 0, 0]]], dtype=np.uint8)
        blue = np.array([[[0, 0, 255]]], dtype=np.uint8)
        lab_red_swapped = np.asarray(rgb_to_lab8(jnp.asarray(red), swap=True))
        lab_blue_true = np.asarray(rgb_to_lab8(jnp.asarray(blue), swap=False))
        np.testing.assert_array_equal(lab_red_swapped, lab_blue_true)

    def test_brightness_saturation(self):
        img = np.array([[[0, 100, 250]]], dtype=np.uint8)
        up = np.asarray(adjust_brightness(jnp.asarray(img), 20))
        np.testing.assert_array_equal(up[0, 0], [20, 120, 255])
        down = np.asarray(adjust_brightness(jnp.asarray(img), -20))
        np.testing.assert_array_equal(down[0, 0], [0, 80, 230])

    def test_hflip(self):
        img = np.arange(12, dtype=np.uint8).reshape(1, 4, 3)
        np.testing.assert_array_equal(
            np.asarray(hflip(jnp.asarray(img))), img[:, ::-1]
        )
        depth = np.arange(8).reshape(2, 4)
        np.testing.assert_array_equal(
            np.asarray(hflip(jnp.asarray(depth))), depth[:, ::-1]
        )


class TestResize:
    def test_identity(self):
        img = np.random.rand(7, 5).astype(np.float32)
        out = np.asarray(resize_bilinear(jnp.asarray(img), 7, 5))
        np.testing.assert_allclose(out, img, rtol=1e-6)

    def test_hand_computed_downscale(self):
        # cv::resize 4->2: fx = (j+0.5)*2-0.5 = {0.5, 2.5}.
        img = np.array([[0.0, 1.0, 2.0, 3.0]], dtype=np.float32)
        out = np.asarray(resize_bilinear(jnp.asarray(img), 1, 2))
        np.testing.assert_allclose(out[0], [0.5, 2.5], rtol=1e-6)

    def test_hand_computed_upscale(self):
        # 2->4: fx = (j+0.5)*0.5-0.5 = {-0.25, 0.25, 0.75, 1.25};
        # borders clamp to taps (0,frac0) and (1,frac0).
        img = np.array([[0.0, 2.0]], dtype=np.float32)
        out = np.asarray(resize_bilinear(jnp.asarray(img), 1, 4))
        np.testing.assert_allclose(out[0], [0.0, 0.5, 1.5, 2.0], rtol=1e-6)

    def test_multichannel(self):
        img = np.random.rand(6, 8, 9).astype(np.float32)
        out = np.asarray(resize_bilinear(jnp.asarray(img), 3, 4))
        for c in range(9):
            ref = np.asarray(resize_bilinear(jnp.asarray(img[..., c]), 3, 4))
            np.testing.assert_allclose(out[..., c], ref, rtol=1e-6)

    def test_u8_close_to_float(self):
        rng = np.random.default_rng(0)
        img = rng.integers(0, 256, (33, 47, 3), dtype=np.uint8)
        fixed = np.asarray(resize_bilinear_u8(jnp.asarray(img), 11, 11))
        flt = np.asarray(resize_bilinear(jnp.asarray(img), 11, 11))
        assert np.abs(fixed.astype(float) - flt).max() <= 1.0


class TestBackproject:
    def test_matches_formula(self):
        rng = np.random.default_rng(1)
        depth = rng.integers(400, 16000, (12, 16)).astype(np.uint16)
        k = np.array([[525.0, 0, 8], [0, 525.0, 6], [0, 0, 1]], dtype=np.float32)
        kinv = np.linalg.inv(k)
        rot = np.array(
            [[0, -1, 0], [1, 0, 0], [0, 0, 1]], dtype=np.float32
        )
        t = np.array([0.5, -0.25, 1.0], dtype=np.float32)
        out = np.asarray(
            backproject(jnp.asarray(depth), kinv, rot, t, 0.5, 15.0)
        )
        m = rot @ kinv
        for y in range(12):
            for x in range(16):
                d = depth[y, x] / 1000.0
                if d < 0.5 or d > 15.0:
                    assert np.isnan(out[y, x]).all()
                else:
                    want = m @ np.array([d * x, d * y, d]) + t
                    # float32 matmul vs float64 oracle: allow f32 rounding.
                    np.testing.assert_allclose(out[y, x], want, rtol=1e-3, atol=1e-3)

    def test_mask_mm_semantics(self):
        depth = np.array([[499, 500, 15000, 15001]], dtype=np.uint16)
        mask = np.asarray(depth_valid_mask(jnp.asarray(depth), 0.5, 15.0))
        np.testing.assert_array_equal(mask[0], [False, True, True, False])


class TestDistanceTransform:
    def test_matches_pcl_chamfer_oracle(self):
        """The vectorized two-pass chamfer equals the sequential PCL one."""
        import os
        import sys

        sys.path.insert(0, os.path.dirname(__file__))
        from pcl_normals_oracle import chamfer_distance_map as oracle_dt

        from rovinasemanticsegmentation_tpu.ops.normals import (
            chamfer_distance_map,
        )

        rng = np.random.default_rng(2)
        for shape, p in [((15, 17), 0.08), ((33, 41), 0.02), ((8, 64), 0.1)]:
            mask = rng.random(shape) < p
            mask[0, 0] = True  # ensure nonempty
            got = np.asarray(chamfer_distance_map(jnp.asarray(mask)))
            want = oracle_dt(mask)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize(
        "shape,p,sat", [((60, 70), 0.01, 10.0), ((45, 33), 0.03, 6.0)]
    )
    def test_saturated_matches_full(self, shape, p, sat):
        """The saturated chamfer clamps identically to the full sequential
        passes wherever the value is consumed (outside the top/bottom
        border of ceil(sat) rows; smoothing clamps at the saturation) — at
        EVERY column, including the never-relaxed 0/w-1."""
        from rovinasemanticsegmentation_tpu.ops.normals import (
            chamfer_distance_map,
        )

        rng = np.random.default_rng(4)
        mask = rng.random(shape) < p
        mask[3, 5] = True
        full = np.minimum(
            np.asarray(chamfer_distance_map(jnp.asarray(mask))), sat
        )
        got = np.minimum(
            np.asarray(chamfer_distance_map(jnp.asarray(mask), saturation=sat)),
            sat,
        )
        b = int(np.ceil(sat))
        np.testing.assert_allclose(got[b:-b], full[b:-b], rtol=1e-5, atol=1e-5)

    def test_saturated_iter_edge_seeds(self):
        """Change pixels ON the never-relaxed columns/rows must still seed
        their neighbors (PCL's chains read the frozen edge values)."""
        from rovinasemanticsegmentation_tpu.ops.normals import (
            chamfer_distance_map,
        )

        sat = 6.0
        mask = np.zeros((30, 40), bool)
        mask[15, 0] = True   # left edge column
        mask[0, 20] = True   # top row
        mask[29, 39] = True  # bottom-right corner
        full = np.minimum(
            np.asarray(chamfer_distance_map(jnp.asarray(mask))), sat
        )
        it = np.minimum(
            np.asarray(
                chamfer_distance_map(
                    jnp.asarray(mask), saturation=sat
                )
            ),
            sat,
        )
        b = int(np.ceil(sat))
        np.testing.assert_allclose(it[b:-b], full[b:-b], rtol=1e-5, atol=1e-5)


class TestNormals:
    def _angles(self, pts):
        return np.asarray(normal_angles(jnp.asarray(pts.astype(np.float32))))

    def test_floor_plane(self):
        h, w = 40, 50
        ys, xs = np.mgrid[0:h, 0:w]
        pts = np.stack([xs * 0.01, ys * 0.01, np.full((h, w), 2.0)], -1)
        ang = self._angles(pts)
        interior = ang[10:-10, 10:-10]
        np.testing.assert_allclose(interior, 0.0, atol=1e-4)

    def test_wall_plane(self):
        h, w = 40, 50
        ys, xs = np.mgrid[0:h, 0:w]
        pts = np.stack([xs * 0.01, np.full((h, w), 3.0), ys * 0.01], -1)
        ang = self._angles(pts)
        interior = ang[10:-10, 10:-10]
        np.testing.assert_allclose(interior, np.pi / 2, atol=1e-4)

    def test_invalid_region_is_minus_two(self):
        h, w = 44, 44
        ys, xs = np.mgrid[0:h, 0:w]
        pts = np.stack([xs * 0.01, ys * 0.01, np.full((h, w), 2.0)], -1)
        pts[12:19, 12:19] = np.nan
        ang = self._angles(pts)
        assert (ang[13:18, 13:18] == -2.0).all()
        # Far from the hole, still a clean floor.
        np.testing.assert_allclose(ang[26:31, 26:31], 0.0, atol=1e-4)

    def test_border_frame_is_minus_two(self):
        """PCL skips int(normal_smoothing_size) border pixels outright."""
        h, w = 40, 50
        ys, xs = np.mgrid[0:h, 0:w]
        pts = np.stack([xs * 0.01, ys * 0.01, np.full((h, w), 2.0)], -1)
        ang = self._angles(pts)
        assert (ang[:10, :] == -2.0).all()
        assert (ang[-10:, :] == -2.0).all()
        assert (ang[:, :10] == -2.0).all()
        assert (ang[:, -10:] == -2.0).all()

    def test_discontinuity_limits_smoothing(self):
        # Two parallel floors at different heights: pixels adjacent to the
        # jump get small smoothing windows, but normals stay floor-like on
        # each side rather than blending across the 1 m step.
        h, w = 40, 60
        ys, xs = np.mgrid[0:h, 0:w]
        z = np.where(xs < 30, 2.0, 3.0)
        pts = np.stack([xs * 0.01, ys * 0.01, z], -1)
        ang = self._angles(pts)
        np.testing.assert_allclose(ang[15:25, 10:20], 0.0, atol=1e-3)
        np.testing.assert_allclose(ang[15:25, 40:50], 0.0, atol=1e-3)


class TestNormalsVsPclOracle:
    """normal_angles vs the literal scalar PCL port (VERDICT r1 item #5).

    Covers the drift-prone corners: chamfer distances near step edges, NaN
    holes, truncated even-width rect windows, and the border frame.
    """

    def _compare(self, pts, **kw):
        import sys

        sys.path.insert(0, os.path.dirname(__file__))
        from pcl_normals_oracle import normal_angles_oracle

        from rovinasemanticsegmentation_tpu.ops.normals import normal_angles

        want = normal_angles_oracle(pts, **kw)
        got = np.asarray(
            normal_angles(jnp.asarray(pts.astype(np.float32)), **kw)
        )
        # -2 masks must agree exactly; angles to f32-vs-f64 tolerance.
        np.testing.assert_array_equal(got == -2.0, want == -2.0)
        diff = np.abs(got - want)
        # acos is ill-conditioned where the cross product nearly vanishes
        # (noisy near-planar windows): allow <= 0.5% of pixels beyond the
        # f32 tolerance, everything else tight.
        loose = diff > 2e-3
        assert loose.mean() <= 0.005, (
            f"{loose.sum()} pixels beyond tolerance, worst {diff.max()}"
        )

    def test_smooth_scene_with_holes(self):
        r = np.random.default_rng(0)
        h, w = 36, 44
        ys, xs = np.mgrid[0:h, 0:w]
        z = 2.0 + 0.3 * np.sin(xs / 7.0) + 0.2 * (ys / h)
        pts = np.stack([(xs - w / 2) * z / 500, (ys - h / 2) * z / 500, z], -1)
        pts[r.random((h, w)) < 0.04] = np.nan
        self._compare(pts)

    def test_step_edges(self):
        h, w = 40, 48
        ys, xs = np.mgrid[0:h, 0:w]
        z = np.where(xs < 24, 2.0, 3.0) + 0.01 * ys / h
        z[28:, :10] = 1.5  # a third plane in the lower-left corner
        pts = np.stack([(xs - w / 2) * z / 500, (ys - h / 2) * z / 500, z], -1)
        self._compare(pts)

    def test_noisy_depth(self):
        r = np.random.default_rng(3)
        h, w = 32, 40
        ys, xs = np.mgrid[0:h, 0:w]
        z = 2.5 + r.normal(0, 0.01, (h, w))
        z[r.random((h, w)) < 0.02] = np.nan
        pts = np.stack([(xs - w / 2) * z / 500, (ys - h / 2) * z / 500, z], -1)
        self._compare(pts)

    def test_smaller_smoothing_size(self):
        h, w = 30, 30
        ys, xs = np.mgrid[0:h, 0:w]
        z = 2.0 + 0.2 * np.sin(ys / 5.0)
        pts = np.stack([(xs - w / 2) * z / 500, (ys - h / 2) * z / 500, z], -1)
        self._compare(pts, normal_smoothing_size=6.0)


class TestPatches:
    def _oracle_patch(self, padded, x, y, depth_m, patch_size, reduce):
        """Direct reimplementation: crop window, fixed-point resize."""
        half = int(patch_size / (2.0 * depth_m))
        wsize = 2 * half + 1
        oy, ox = y + patch_size - half, x + patch_size - half
        win = padded[oy : oy + wsize, ox : ox + wsize].astype(np.int64)

        def taps(n_src, n_dst):
            out = []
            for j in range(n_dst):
                fx = (j + 0.5) * n_src / n_dst - 0.5
                sx = int(np.floor(fx))
                frac = fx - sx
                if sx < 0:
                    sx, frac = 0, 0.0
                if sx >= n_src - 1:
                    sx, frac = n_src - 1, 0.0
                out.append(
                    (sx, min(sx + 1, n_src - 1),
                     int(round((1 - frac) * 2048)), int(round(frac * 2048)))
                )
            return out

        tx = taps(wsize, reduce)
        ty = taps(wsize, reduce)
        out = np.zeros((reduce, reduce, 3), dtype=np.uint8)
        for i, (sy0, sy1, wy0, wy1) in enumerate(ty):
            for j, (sx0, sx1, wx0, wx1) in enumerate(tx):
                row0 = win[sy0, sx0] * wx0 + win[sy0, sx1] * wx1
                row1 = win[sy1, sx0] * wx0 + win[sy1, sx1] * wx1
                acc = row0 * wy0 + row1 * wy1
                out[i, j] = np.clip((acc + (1 << 21)) >> 22, 0, 255)
        return out

    def test_matches_oracle(self):
        rng = np.random.default_rng(3)
        patch_size, reduce = 21, 5
        img = rng.integers(0, 256, (40, 48, 3), dtype=np.uint8)
        padded = np.asarray(reflect_pad_image(jnp.asarray(img), patch_size))
        xs = np.array([0, 10, 47, 25], dtype=np.int32)
        ys = np.array([0, 20, 39, 7], dtype=np.int32)
        depths = np.array([0.6, 1.3, 5.0, 11.0], dtype=np.float32)
        got = np.asarray(
            extract_patches(
                jnp.asarray(padded), jnp.asarray(xs), jnp.asarray(ys),
                jnp.asarray(depths), patch_size=patch_size, reduce_size=reduce,
            )
        )
        for p in range(len(xs)):
            want = self._oracle_patch(
                padded, xs[p], ys[p], depths[p], patch_size, reduce
            )
            np.testing.assert_array_equal(got[p], want)

    def test_reflect_padding_matches_opencv_reflect(self):
        # BORDER_REFLECT duplicates the edge pixel: fedcba|abcdefgh.
        img = np.array([[1, 2, 3]], dtype=np.uint8)
        padded = np.asarray(reflect_pad_image(jnp.asarray(img), 2))
        np.testing.assert_array_equal(padded[2], [2, 1, 1, 2, 3, 3, 2])


class TestNormalsGridPath:
    def test_grid_matches_full_res(self):
        """The strided-slice box-sum path must equal the gather path."""
        from rovinasemanticsegmentation_tpu.ops.normals import (
            normal_angles,
            normal_angles_grid,
        )

        rng = np.random.default_rng(11)
        h, w = 40, 56
        ys, xs = np.mgrid[0:h, 0:w]
        z = 2.0 + 0.01 * xs + 0.004 * ys
        pts = np.stack([xs * 0.01, ys * 0.01, z], -1).astype(np.float32)
        pts[10:14, 20:26] = np.nan  # a hole
        pts[:, 40:] += 1.0  # a depth step
        full = np.asarray(normal_angles(jnp.asarray(pts)))
        for s in (2, 5):
            grid = np.asarray(normal_angles_grid(jnp.asarray(pts), s))
            np.testing.assert_allclose(grid, full[::s, ::s], rtol=1e-5, atol=1e-6)

    @pytest.mark.slow  # grid path covered fast by test_grid_matches_full_res
    def test_grid_large_stride_phase_extent(self):
        # stride 8 on a 100x120 image: the last phase sub-images are short
        # without the exact back-padding (dynamic_slice would clamp).
        from rovinasemanticsegmentation_tpu.ops.normals import (
            normal_angles,
            normal_angles_grid,
        )

        h, w = 100, 120
        ys, xs = np.mgrid[0:h, 0:w]
        pts = np.stack([xs * 0.01, ys * 0.01, 2.0 + 0.01 * xs], -1).astype(
            np.float32
        )
        full = np.asarray(normal_angles(jnp.asarray(pts)))
        for s in (7, 8):
            grid = np.asarray(normal_angles_grid(jnp.asarray(pts), s))
            np.testing.assert_allclose(grid, full[::s, ::s], rtol=1e-5, atol=1e-6)


class TestPatchesGrid:
    """The extractor's patch stage (the per-point gather over the whole
    stride grid) against the NumPy crop-and-resize oracle, including
    masked points (depth 0 -> the h=0 window) and grids whose last row and
    column sit past the image's stride multiple."""

    @pytest.mark.parametrize("b,r,s,h,w,seed", [
        (9, 5, 2, 32, 48, 0),
        (7, 3, 1, 17, 33, 1),
        (11, 11, 4, 24, 40, 2),
        (9, 5, 2, 35, 47, 3),
    ])
    def test_matches_oracle(self, b, r, s, h, w, seed):
        from rovinasemanticsegmentation_tpu.ops.patches import (
            extract_patches_grid,
        )

        rng = np.random.default_rng(seed)
        img = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        padded = np.asarray(reflect_pad_image(jnp.asarray(img), b))
        gh, gw = -(-h // s), -(-w // s)
        # Depth >= 0.6 m keeps half = b / (2 d) below the border b.
        depth = rng.uniform(0.6, 8.0, (gh, gw)).astype(np.float32)
        depth[rng.random((gh, gw)) < 0.15] = 0.0
        got = np.asarray(
            extract_patches_grid(
                jnp.asarray(padded), jnp.asarray(depth),
                patch_size=b, reduce_size=r, stride=s,
            )
        )
        assert got.shape == (gh, gw, r, r, 3)
        oracle = TestPatches()._oracle_patch
        for gy in range(gh):
            for gx in range(gw):
                d = float(depth[gy, gx])
                if d <= 0:
                    continue
                want = oracle(padded, gx * s, gy * s, d, b, r)
                np.testing.assert_array_equal(got[gy, gx], want)

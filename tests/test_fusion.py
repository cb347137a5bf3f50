"""Projector, unary accumulation, and local-map pipeline tests."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.fusion.projector import MultiProjector
from rovinasemanticsegmentation_tpu.fusion.unaries import accumulate_unaries
from rovinasemanticsegmentation_tpu.pipelines.local_map import (
    CrfParams,
    LocalMapPipeline,
    MapNodeFrames,
)
from rovinasemanticsegmentation_tpu.utils.calibration import Calibration


def simple_projector(h=20, w=24, ncam=1):
    calibs = [
        Calibration(
            intrinsic=np.array([[20.0, 0, w / 2], [0, 20.0, h / 2], [0, 0, 1]]),
            rotation=np.eye(3),
            translation=np.zeros(3),
        )
        for _ in range(ncam)
    ]
    return MultiProjector.from_calibrations(
        calibs, h, w, min_distance=0.5, max_distance=15.0
    )


class TestProjector:
    def test_center_point(self):
        proj = simple_projector()
        pts = np.array([[0.0, 0.0, 2.0]], dtype=np.float32)
        zbuf, idx = proj.project(pts, np.eye(4))
        idx = np.asarray(idx)
        assert idx[10, 12] == 0  # principal point
        assert (idx >= 0).sum() == 1
        assert np.isfinite(np.asarray(zbuf)[10, 12])

    def test_zbuffer_keeps_nearest(self):
        proj = simple_projector()
        # Two points on the same ray; nearest wins.
        pts = np.array([[0.0, 0.0, 4.0], [0.0, 0.0, 2.0]], dtype=np.float32)
        _, idx = proj.project(pts, np.eye(4))
        assert np.asarray(idx)[10, 12] == 1

    def test_behind_and_out_of_range_culled(self):
        proj = simple_projector()
        pts = np.array(
            [[0.0, 0.0, -2.0], [0.0, 0.0, 0.2], [0.0, 0.0, 50.0]], dtype=np.float32
        )
        _, idx = proj.project(pts, np.eye(4))
        assert (np.asarray(idx) == -1).all()

    def test_pose_inverse_applied(self):
        proj = simple_projector()
        # Keyframe at x=+1 looking down +z; world point at (1, 0, 2).
        pose = np.eye(4, dtype=np.float32)
        pose[0, 3] = 1.0
        pts = np.array([[1.0, 0.0, 2.0]], dtype=np.float32)
        _, idx = proj.project(pts, pose)
        assert np.asarray(idx)[10, 12] == 0

    def test_multi_camera_stacking(self):
        h, w = 20, 24
        # Second camera rotated 180 deg about y: sees points behind.
        calibs = [
            Calibration(
                intrinsic=np.array([[20.0, 0, 12], [0, 20.0, 10], [0, 0, 1]]),
                rotation=np.eye(3),
                translation=np.zeros(3),
            ),
            Calibration(
                intrinsic=np.array([[20.0, 0, 12], [0, 20.0, 10], [0, 0, 1]]),
                rotation=np.array([[-1, 0, 0], [0, 1, 0], [0, 0, -1]], dtype=np.float32),
                translation=np.zeros(3),
            ),
        ]
        proj = MultiProjector.from_calibrations(calibs, h, w, 0.5, 15.0)
        pts = np.array([[0, 0, 2.0], [0, 0, -2.0]], dtype=np.float32)
        _, idx = proj.project(pts, np.eye(4))
        idx = np.asarray(idx)
        assert idx[10, 12] == 0  # cam 0 sees the front point
        assert idx[h + 10, 12] == 1  # cam 1 sees the back point


class TestUnaries:
    def test_scatter_add(self):
        post = np.zeros((4, 4, 3), dtype=np.float32)
        post[1, 1] = [0.1, 0.2, 0.7]
        post[2, 2] = [0.5, 0.3, 0.2]
        idx = np.full((4, 4), -1, dtype=np.int32)
        idx[1, 1] = 0
        idx[2, 2] = 0  # two pixels hit the same point
        un = jnp.zeros((2, 3))
        out = np.asarray(accumulate_unaries(un, jnp.asarray(post), jnp.asarray(idx), 2))
        np.testing.assert_allclose(out[0], [0.6, 0.5, 0.9], rtol=1e-6)
        np.testing.assert_allclose(out[1], 0.0)


class TestProjectWinners:
    """The scatter-free fusion path must agree with the index image."""

    def _check(self, proj, pts, pose=None, ncam=1):
        from rovinasemanticsegmentation_tpu.fusion.projector import (
            project_winners,
        )

        pose = np.eye(4, dtype=np.float32) if pose is None else pose
        zbuf, idx = proj.project(pts, pose)
        idx = np.asarray(idx)

        rp = pose[:3, :3].T.astype(np.float32)
        tp = -rp @ pose[:3, 3].astype(np.float32)
        rot = proj.rotations_inv @ rp[None]
        trans = (
            np.einsum("cij,j->ci", proj.rotations_inv, tp)
            + proj.translations_inv
        )
        won, flat = project_winners(
            jnp.asarray(pts, jnp.float32),
            jnp.asarray(rot),
            jnp.asarray(trans),
            jnp.asarray(proj.intrinsics),
            jnp.float32(proj.min_distance),
            jnp.float32(proj.max_distance),
            height=proj.height,
            width=proj.width,
        )
        won = np.asarray(won)
        flat = np.asarray(flat)
        n = len(pts)
        # Winners of the index image == winners of the sort-based path,
        # including the lowest-index tie-break.
        idx_flat = idx.reshape(-1)
        expect = np.zeros(ncam * n, bool)
        for cam in range(ncam):
            for p in range(n):
                f = flat[cam * n + p]
                if f < idx_flat.size and idx_flat[f] == p:
                    expect[cam * n + p] = True
        np.testing.assert_array_equal(won, expect)
        # Every occupied pixel has exactly one winner among its claimants.
        assert won.sum() == (idx_flat >= 0).sum()

    def test_matches_index_image(self):
        proj = simple_projector()
        rng = np.random.default_rng(0)
        pts = np.stack(
            [
                rng.uniform(-0.5, 0.5, 300),
                rng.uniform(-0.4, 0.4, 300),
                rng.uniform(0.6, 10.0, 300),
            ],
            axis=1,
        ).astype(np.float32)
        self._check(proj, pts)

    def test_ties_and_culling(self):
        proj = simple_projector()
        # Same ray, equal depths (tie -> lowest index), plus culled points.
        pts = np.array(
            [
                [0.0, 0.0, 2.0],
                [0.0, 0.0, 2.0],
                [0.0, 0.0, 4.0],
                [0.0, 0.0, -1.0],
                [0.0, 0.0, 50.0],
            ],
            dtype=np.float32,
        )
        self._check(proj, pts)

    def test_multi_camera_and_pose(self):
        proj = simple_projector(ncam=2)
        rng = np.random.default_rng(3)
        pts = np.stack(
            [
                rng.uniform(0.5, 1.5, 200),
                rng.uniform(-0.4, 0.4, 200),
                rng.uniform(1.0, 8.0, 200),
            ],
            axis=1,
        ).astype(np.float32)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = [1.0, 0.0, 0.0]
        self._check(proj, pts, pose=pose, ncam=2)


class TestLocalMapPipeline:
    def _scene(self):
        proj = simple_projector()
        rng = np.random.default_rng(0)
        # Points in front of the camera spread over the image.
        n = 50
        pts = np.stack(
            [
                rng.uniform(-0.4, 0.4, n),
                rng.uniform(-0.3, 0.3, n),
                np.full(n, 2.0),
            ],
            axis=1,
        ).astype(np.float32)
        rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        return proj, pts, rgb

    def _posterior_for(self, proj, pts, label, c):
        # Posterior image voting `label` everywhere.
        h, w = proj.height, proj.width
        post = np.full((h, w, c), 0.1, dtype=np.float32)
        post[..., label] = 5.0
        return post

    def test_plain_argmax_fusion(self):
        proj, pts, rgb = self._scene()
        pipeline = LocalMapPipeline(
            proj, class_counts=[3], unknown_labels=[2], crf=CrfParams()
        )
        node = MapNodeFrames(
            pose=np.eye(4), posteriors=[[self._posterior_for(proj, pts, 1, 3)]]
        )
        labels = pipeline.run(pts, rgb, [node])[0]
        # Visible points labeled 1; points never hit stay Unknown (2).
        _, idx = proj.project(pts, np.eye(4))
        hit = np.unique(np.asarray(idx))
        hit = hit[hit >= 0]
        assert (labels[hit] == 1).all()
        missed = np.setdiff1d(np.arange(len(pts)), hit)
        assert (labels[missed] == 2).all()

    def test_missing_frame_tolerated(self):
        proj, pts, rgb = self._scene()
        pipeline = LocalMapPipeline(proj, [3], [2])
        node = MapNodeFrames(pose=np.eye(4), posteriors=[None])
        labels = pipeline.run(pts, rgb, [node])[0]
        assert (labels == 2).all()  # no votes anywhere -> Unknown

    @pytest.mark.slow
    def test_crf_smoothing_path(self):
        proj, pts, rgb = self._scene()
        pipeline = LocalMapPipeline(
            proj, class_counts=[3], unknown_labels=[2],
            crf=CrfParams(use_dense_crf=True, iterations=5),
        )
        node = MapNodeFrames(
            pose=np.eye(4), posteriors=[[self._posterior_for(proj, pts, 0, 3)]]
        )
        labels = pipeline.run(pts, rgb, [node])[0]
        _, idx = proj.project(pts, np.eye(4))
        hit = np.unique(np.asarray(idx))
        hit = hit[hit >= 0]
        # CRF smoothing keeps the dominant vote on observed points.
        assert (labels[hit] == 0).mean() > 0.9

    def test_multi_layer(self):
        proj, pts, rgb = self._scene()
        pipeline = LocalMapPipeline(proj, [3, 4], [2, 3])
        node = MapNodeFrames(
            pose=np.eye(4),
            posteriors=[[
                self._posterior_for(proj, pts, 1, 3),
                self._posterior_for(proj, pts, 2, 4),
            ]],
        )
        labels = pipeline.run(pts, rgb, [node])
        assert len(labels) == 2
        _, idx = proj.project(pts, np.eye(4))
        hit = np.unique(np.asarray(idx))
        hit = hit[hit >= 0]
        assert (labels[0][hit] == 1).all()
        assert (labels[1][hit] == 2).all()

    @pytest.mark.slow  # per-map auto-selection both outcomes also run in dryrun_multichip
    def test_mesh_crf_auto_selection(self):
        """With a mesh, label_map picks the sharded CRF variant per map
        from the plan's comm volumes, and both choices match the
        single-chip labels (VERDICT r3 item 8)."""
        from rovinasemanticsegmentation_tpu.parallel.mesh import make_mesh

        proj = simple_projector()
        rng = np.random.default_rng(3)
        crf = CrfParams(use_dense_crf=True, iterations=4)
        mesh = make_mesh(8)
        sharded = LocalMapPipeline(
            proj, [3, 4], [2, 3], crf=crf, mesh=mesh
        )
        single = LocalMapPipeline(
            proj, [3, 4], [2, 3], crf=crf, use_device_lattice=False
        )

        def unaries_for(n):
            return [
                rng.normal(size=(n, 3)).astype(np.float32) * 2,
                rng.normal(size=(n, 4)).astype(np.float32) * 2,
            ]

        # Dense cluster: vertices shared across every shard, so the halo
        # publish lists rival M and the replicated psum is cheaper
        # (measured: halo 33792 vs psum 9192 values/filter).
        n = 203
        pts_r = rng.normal(size=(n, 3)).astype(np.float32) * 2
        rgb_r = np.clip(
            rng.normal(size=(n, 3)) * 0.25 + 0.5, 0, 1
        ).astype(np.float32)
        u = unaries_for(n)
        got = sharded.label_map(pts_r, rgb_r, [jnp.asarray(x) for x in u])
        want = single.label_map(pts_r, rgb_r, [jnp.asarray(x) for x in u])
        assert sharded.last_crf_variant == "replicated"
        for g, w in zip(got, want):
            assert (g == w).mean() > 0.98  # float-order ties at the floor

        # Long smooth trajectory: contiguous shard arcs, boundary only at
        # arc ends — halo wins (measured: 1152 vs 10544 values/filter).
        n = 4096
        t = np.linspace(0, 400, n)
        pts_l = np.stack(
            [t * 0.5, 3 * np.sin(t * 0.2), 4.0 + 3 * np.cos(t * 0.13)],
            axis=1,
        ).astype(np.float32)
        rgb_l = np.stack(
            [
                np.abs(np.sin(t * 0.01)),
                np.abs(np.sin(t * 0.07)),
                np.abs(np.cos(t * 0.03)),
            ],
            axis=1,
        ).astype(np.float32)
        u = unaries_for(n)
        got = sharded.label_map(pts_l, rgb_l, [jnp.asarray(x) for x in u])
        want = single.label_map(pts_l, rgb_l, [jnp.asarray(x) for x in u])
        assert sharded.last_crf_variant == "vertex"
        for g, w in zip(got, want):
            assert (g == w).mean() > 0.98


class TestFusedLayers:
    def test_multi_mean_field_matches_per_layer(self):
        """The fused multi-layer mean-field equals per-layer runs exactly."""
        import jax.numpy as jnp
        from rovinasemanticsegmentation_tpu.models.crf import (
            potts_mean_field,
            potts_mean_field_multi,
        )
        from rovinasemanticsegmentation_tpu.models.lattice import (
            build_lattice,
            lattice_filter,
            pad_lattice,
        )

        rng = np.random.default_rng(9)
        n = 300
        feats = rng.normal(size=(n, 4)).astype(np.float32)
        lat = pad_lattice(build_lattice(feats))
        offsets = jnp.asarray(lat.offsets)
        bary = jnp.asarray(lat.barycentric)
        n1 = jnp.asarray(lat.blur_n1)
        n2 = jnp.asarray(lat.blur_n2)
        raw = lattice_filter(
            jnp.ones((n, 1)), offsets, bary, n1, n2, lat.num_vertices
        )[:, 0]
        norm = 1.0 / jnp.sqrt(raw + 1e-20)
        w = jnp.float32(3.0)
        blocks = (4, 6)
        u = rng.normal(size=(n, sum(blocks))).astype(np.float32)
        fused = np.asarray(
            potts_mean_field_multi(
                jnp.asarray(u), offsets, bary, n1, n2, norm, w,
                blocks, lat.num_vertices, 5,
            )
        )
        start = 0
        for c in blocks:
            single = np.asarray(
                potts_mean_field(
                    jnp.asarray(u[:, start : start + c]),
                    offsets, bary, n1, n2, norm, w, lat.num_vertices, 5,
                )
            )
            np.testing.assert_allclose(
                fused[:, start : start + c], single, rtol=1e-6, atol=1e-7
            )
            start += c

    def test_transposed_multi_matches(self):
        """potts_mean_field_multi_t (serving path) == potts_mean_field_multi
        up to splat summation order."""
        import jax.numpy as jnp
        from rovinasemanticsegmentation_tpu.models.crf import (
            potts_mean_field_multi,
            potts_mean_field_multi_t,
        )
        from rovinasemanticsegmentation_tpu.models.lattice import (
            attach_sorted_stream,
            build_lattice,
            lattice_filter,
            pad_lattice,
        )

        rng = np.random.default_rng(10)
        n = 300
        feats = rng.normal(size=(n, 6)).astype(np.float32)
        lat = attach_sorted_stream(pad_lattice(build_lattice(feats), 64))
        offsets = jnp.asarray(lat.offsets)
        bary = jnp.asarray(lat.barycentric)
        n1 = jnp.asarray(lat.blur_n1)
        n2 = jnp.asarray(lat.blur_n2)
        raw = lattice_filter(
            jnp.ones((n, 1)), offsets, bary, n1, n2, lat.num_vertices
        )[:, 0]
        norm = 1.0 / jnp.sqrt(raw + 1e-20)
        w = jnp.float32(10.0)
        blocks = (8, 9)
        u = rng.normal(size=(n, sum(blocks))).astype(np.float32)
        want = np.asarray(
            potts_mean_field_multi(
                jnp.asarray(u), offsets, bary, n1, n2, norm, w,
                blocks, lat.num_vertices, 10,
            )
        )
        got = np.asarray(
            potts_mean_field_multi_t(
                jnp.asarray(u.T),
                jnp.asarray(lat.sorted_points),
                jnp.asarray(lat.sorted_weights),
                jnp.asarray(lat.seg_starts),
                jnp.asarray(lat.seg_ends),
                jnp.asarray(lat.offsets.T),
                jnp.asarray(lat.barycentric.T),
                n1, n2, norm, w, blocks, lat.num_vertices, 10,
            )
        ).T
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


class TestStreamingPipeline:
    @pytest.mark.slow
    def test_one_dispatch_matches_separate_paths(self):
        """The fused streaming step (frame batch + maps in ONE dispatch)
        must reproduce the separate frame-batch and map-dispatch paths
        exactly — the fusion is a graph restructure, not a math change."""
        from rovinasemanticsegmentation_tpu.features.extractor import (
            FeatureConfig,
        )
        from rovinasemanticsegmentation_tpu.models.forest import random_forest
        from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
            SingleFramePipeline,
        )
        from rovinasemanticsegmentation_tpu.pipelines.streaming import (
            StreamingPipeline,
            pack_poses,
        )
        from rovinasemanticsegmentation_tpu.utils.calibration import (
            Calibration,
        )

        rng = np.random.default_rng(2)
        h, w, n = 32, 40, 70
        map_every, batch = 2, 4
        calib = Calibration(
            intrinsic=np.array(
                [[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]]
            ),
            rotation=np.eye(3),
            translation=np.zeros(3),
        )
        proj = MultiProjector.from_calibrations(
            [calib], h, w, min_distance=0.5, max_distance=15.0
        )
        forest = random_forest(
            rng, num_trees=2, depth=7, num_features=366,
            class_counts=[3, 4], max_nodes=201,
        )
        fp = SingleFramePipeline(
            FeatureConfig(), forest, stride=2, fill_value=0.0,
        )
        mp = LocalMapPipeline(
            proj, [3, 4], [2, 3],
            crf=CrfParams(use_dense_crf=True, iterations=3),
        )
        rgbs = np.stack([
            rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
            for _ in range(batch)
        ])
        depths = np.stack([
            rng.integers(600, 9000, (h, w)).astype(np.uint16)
            for _ in range(batch)
        ])
        kinv = np.tile(
            calib.intrinsic_inverse[None], (batch, 1, 1)
        ).astype(np.float32)
        rot = np.tile(np.eye(3, dtype=np.float32)[None], (batch, 1, 1))
        trans = np.zeros((batch, 3), np.float32)
        pts = np.stack(
            [
                rng.uniform(-0.3, 0.3, n),
                rng.uniform(-0.25, 0.25, n),
                rng.uniform(1.5, 2.5, n),
            ],
            axis=1,
        ).astype(np.float32)
        clouds = np.stack([pts, pts + 0.01])
        crgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)

        # Separate paths: frame batch, then maps via run_device (the first
        # map validates the vertex bucket — streaming requires that).
        results = fp.run_batch_stacked(rgbs, depths, kinv, rot, trans)
        want_maps = []
        for m in range(batch // map_every):
            nodes = [
                MapNodeFrames(
                    pose=np.eye(4), posteriors=[list(r.posteriors)]
                )
                for r in results[m * map_every : (m + 1) * map_every]
            ]
            want_maps.append(
                [np.asarray(l) for l in mp.run_device(clouds[m], crgb, nodes)]
            )
        assert n in mp._m_checked

        stream = StreamingPipeline(fp, mp, map_every)
        poses = pack_poses(proj, [np.eye(4)] * map_every)
        frame_labels, map_labels = stream.run_staged(
            rgbs, depths, kinv, rot, trans, clouds, crgb,
            np.stack([poses] * (batch // map_every)),
        )
        for i, r in enumerate(results):
            for a, b in zip(frame_labels[i], r.labels):
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for m in range(batch // map_every):
            for a, b in zip(map_labels[m], want_maps[m]):
                np.testing.assert_array_equal(np.asarray(a), b)


class TestFusedMapDispatch:
    @pytest.mark.slow
    def test_fused_steady_state_matches_split_path(self):
        """run_device's single-dispatch steady state (_map_fused) must
        produce exactly the split path's labels: the first map of a cloud
        size takes the split (bucket-validating) path, later ones the fused
        path; identical inputs through both must agree bit-for-bit."""
        rng = np.random.default_rng(5)
        proj = simple_projector()
        h, w, n = proj.height, proj.width, 60
        pts = np.stack(
            [
                rng.uniform(-0.4, 0.4, n),
                rng.uniform(-0.3, 0.3, n),
                rng.uniform(1.5, 2.5, n),
            ],
            axis=1,
        ).astype(np.float32)
        rgb = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        posts = [
            [[rng.uniform(0, 2, (h, w, 3)).astype(np.float32),
              rng.uniform(0, 2, (h, w, 4)).astype(np.float32)]]
            for _ in range(2)
        ]
        nodes = [MapNodeFrames(pose=np.eye(4), posteriors=p) for p in posts]
        pipeline = LocalMapPipeline(
            proj, class_counts=[3, 4], unknown_labels=[2, 3],
            crf=CrfParams(use_dense_crf=True, iterations=3),
        )
        first = [np.asarray(l) for l in pipeline.run_device(pts, rgb, nodes)]
        assert n in pipeline._m_checked  # split path validated the bucket
        second = [np.asarray(l) for l in pipeline.run_device(pts, rgb, nodes)]
        for a, b in zip(first, second):
            np.testing.assert_array_equal(a, b)

"""Forest descent kernel (Pallas, Triton route): interpret-mode parity with
the plain XLA descent and the NumPy-style oracle, its wrapper's shapes and
padding, its lowering for the GPU, and the per-platform descent choice."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.models.forest import (
    ForestPredictor,
    TreeArrays,
    _find_leaves,
    _find_leaves_packed,
    build_forest,
    random_forest,
)
from rovinasemanticsegmentation_tpu.ops.forest_pallas import (
    find_leaves,
    find_leaves_triton,
    select_descent,
)


def _kernel_leaves(forest, x, **kw):
    pred = ForestPredictor(forest)
    return np.asarray(
        find_leaves_triton(
            jnp.asarray(x), pred.records, pred.max_depth, pred.feat_bits,
            interpret=True, **kw,
        )
    )


def _oracle_leaves(forest, x):
    pred = ForestPredictor(forest)
    return np.asarray(
        _find_leaves(
            jnp.asarray(x), pred.split_feature, pred.threshold,
            pred.left_child, pred.max_depth,
        )
    )


class TestTritonDescent:
    @pytest.mark.parametrize("seed,trees,depth,nodes,feats", [
        (0, 4, 8, 301, 150),
        (1, 2, 12, 801, 150),
        (5, 2, 6, 101, 1500),  # feature ids above 1024
        (7, 5, 7, 201, 366),  # odd tree count, the fixture's feature width
        (3, 3, 9, 601, 366),
    ])
    def test_leaves_match_plain_descents(self, seed, trees, depth, nodes, feats):
        rng = np.random.default_rng(seed)
        forest = random_forest(rng, trees, depth, feats, [4], max_nodes=nodes)
        x = rng.normal(size=(700, feats)).astype(np.float32)
        got = _kernel_leaves(forest, x)
        pred = ForestPredictor(forest)
        packed = np.asarray(
            _find_leaves_packed(
                jnp.asarray(x), pred.records, pred.max_depth, pred.feat_bits
            )
        )
        np.testing.assert_array_equal(got, packed)
        np.testing.assert_array_equal(got, _oracle_leaves(forest, x))

    @pytest.mark.parametrize("seed,trees,depth,nodes", [
        (0, 4, 8, 301), (1, 2, 12, 801),
    ])
    def test_posterior_parity(self, seed, trees, depth, nodes):
        rng = np.random.default_rng(seed)
        forest = random_forest(rng, trees, depth, 150, [8, 9], max_nodes=nodes)
        x = jnp.asarray(rng.normal(size=(700, 150)).astype(np.float32))
        pred = ForestPredictor(forest)
        leaves = find_leaves(
            x, pred.records, max_depth=pred.max_depth,
            feat_bits=pred.feat_bits, descent="triton", interpret=True,
        )
        from rovinasemanticsegmentation_tpu.models.forest import (
            _sum_leaf_histograms,
        )

        got = np.asarray(_sum_leaf_histograms(pred.leaf_hist, leaves))
        np.testing.assert_allclose(
            got, np.asarray(pred.log_posterior(x)), rtol=1e-5, atol=1e-6
        )

    @pytest.mark.parametrize("n_points", [1, 127, 129, 300])
    def test_points_not_a_block_multiple(self, n_points):
        rng = np.random.default_rng(n_points)
        forest = random_forest(rng, 3, 7, 40, [4], max_nodes=151)
        x = rng.normal(size=(n_points, 40)).astype(np.float32)
        got = _kernel_leaves(forest, x)
        assert got.shape == (n_points, 3)
        np.testing.assert_array_equal(got, _oracle_leaves(forest, x))

    @pytest.mark.parametrize("block,num_warps", [(32, 1), (64, 2), (256, 8)])
    def test_block_sizes(self, block, num_warps):
        rng = np.random.default_rng(block)
        forest = random_forest(rng, 2, 8, 60, [4], max_nodes=201)
        x = rng.normal(size=(333, 60)).astype(np.float32)
        got = _kernel_leaves(forest, x, block=block, num_warps=num_warps)
        np.testing.assert_array_equal(got, _oracle_leaves(forest, x))

    def test_single_node_tree(self):
        tree = TreeArrays(
            split_feature=np.zeros(1, np.int32),
            threshold=np.zeros(1, np.float32),
            left_child=np.zeros(1, np.int32),
            leaf_hist=np.array([[[1.0, 2.0]]], np.float32),
        )
        forest = build_forest([tree], [2])
        x = np.random.default_rng(0).normal(size=(9, 3)).astype(np.float32)
        np.testing.assert_array_equal(_kernel_leaves(forest, x), 0)

    def test_threshold_equality_goes_right(self):
        # Equality goes right, as in the reference (classifier.cpp:105).
        tree = TreeArrays(
            split_feature=np.array([0, 0, 0], np.int32),
            threshold=np.array([1.0, 0, 0], np.float32),
            left_child=np.array([1, 0, 0], np.int32),
            leaf_hist=np.zeros((3, 1, 2), np.float32),
        )
        forest = build_forest([tree], [2])
        x = np.array([[0.999], [1.0], [1.001]], np.float32)
        np.testing.assert_array_equal(_kernel_leaves(forest, x)[:, 0], [1, 2, 2])

    def test_lowers_for_the_gpu(self):
        """The kernel lowers to Triton for CUDA without a card; what the
        GPU's compiler says of it is checked on the card (tests/test_gpu.py)."""
        rng = np.random.default_rng(0)
        forest = random_forest(rng, 4, 8, 366, [8, 9], max_nodes=301)
        pred = ForestPredictor(forest)
        x = jnp.zeros((1000, 366), jnp.float32)
        fn = functools.partial(
            find_leaves_triton, max_depth=pred.max_depth,
            feat_bits=pred.feat_bits,
        )
        text = (
            jax.jit(fn).trace(x, pred.records)
            .lower(lowering_platforms=("cuda",)).as_text()
        )
        assert "forest_descent" in text


class TestDescentChoice:
    @pytest.mark.parametrize("platform,descent", [
        ("gpu", "triton"), ("cpu", "xla"),
    ])
    def test_platform_descent(self, platform, descent):
        assert select_descent(platform) == descent

    @pytest.mark.parametrize("platform", ["rocm", "metal"])
    def test_unknown_platform_raises(self, platform):
        with pytest.raises(ValueError, match="no forest descent"):
            select_descent(platform)

    def test_unknown_descent_raises(self):
        with pytest.raises(ValueError, match="unknown descent"):
            find_leaves(
                jnp.zeros((4, 3)), jnp.zeros((1, 1, 2), jnp.int32),
                max_depth=1, feat_bits=2, descent="nope",
            )

    def test_pipeline_takes_the_platform_default(self):
        from rovinasemanticsegmentation_tpu.features.extractor import (
            FeatureConfig,
        )
        from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
            SingleFramePipeline,
        )

        rng = np.random.default_rng(0)
        forest = random_forest(rng, 2, 4, 78, [3], max_nodes=15)
        cfg = FeatureConfig(patch_size=15, patch_size_reduce=5)
        pipe = SingleFramePipeline(cfg, forest, stride=2)
        assert pipe.descent == select_descent(jax.default_backend()) == "xla"
        with pytest.raises(ValueError, match="unknown descent"):
            SingleFramePipeline(cfg, forest, stride=2, descent="nope")


class TestKernelPipeline:
    def test_pipeline_kernel_matches_xla(self):
        """Full single-frame slice through the descent kernel (interpret
        mode) vs the XLA descent, at the fixture's 366 features."""
        from rovinasemanticsegmentation_tpu.features.extractor import (
            FeatureConfig,
        )
        from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
            SingleFramePipeline,
        )
        from rovinasemanticsegmentation_tpu.utils.calibration import Calibration

        rng = np.random.default_rng(0)
        h, w = 32, 40
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        depth = rng.integers(600, 9000, (h, w)).astype(np.uint16)
        calib = Calibration(
            intrinsic=np.array([[40.0, 0, w / 2], [0, 40.0, h / 2], [0, 0, 1]]),
            rotation=np.eye(3),
            translation=np.zeros(3),
        )
        cfg = FeatureConfig(patch_size=77, patch_size_reduce=11)
        assert cfg.feature_length == 366
        forest = random_forest(
            rng, num_trees=3, depth=9, num_features=366,
            class_counts=[8, 9], max_nodes=601,
        )
        ref = SingleFramePipeline(cfg, forest, stride=2, descent="xla")
        ker = SingleFramePipeline(
            cfg, forest, stride=2, descent="triton", interpret=True
        )
        r_ref = ref.run(rgb, depth, calib)
        r_ker = ker.run(rgb, depth, calib)
        for a, b in zip(r_ref.posteriors, r_ker.posteriors):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        for a, b in zip(r_ref.labels, r_ker.labels):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


class TestLoopFormProbe:
    """scripts/probe_triton_while.py, which re-checks on the GPU whether a
    while loop compiles inside a Triton kernel: each of its loop forms
    gives the reference leaves through the Pallas interpreter."""

    @pytest.mark.parametrize("form", ["fori", "while_bool", "while_int"])
    def test_form_is_exact_interpreted(self, form):
        import importlib.util
        import os

        path = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                            "scripts", "probe_triton_while.py")
        spec = importlib.util.spec_from_file_location("probe_triton_while", path)
        probe = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(probe)
        assert probe.run_form(form, interpret=True)

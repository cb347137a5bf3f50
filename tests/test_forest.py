"""Forest inference + binary codec tests against a NumPy oracle.

The oracle re-implements the C++ semantics verbatim:
- findLeafNode: while leftChild != 0: node = left + (x[f] >= thr)
  (classifier.cpp:97-117)
- multiClassLogPosterior: sum of per-tree leaf log-histograms
  (classifier.cpp:187-208)
"""

import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.models.forest import (
    Forest,
    ForestPredictor,
    RawTree,
    TreeArrays,
    build_forest,
    load_forest,
    random_forest,
    read_reference_forest,
    save_forest,
    write_reference_forest,
)


def oracle_find_leaf(tree: TreeArrays, x: np.ndarray) -> int:
    node = 0
    while tree.left_child[node] != 0:
        if x[tree.split_feature[node]] < tree.threshold[node]:
            node = tree.left_child[node]
        else:
            node = tree.left_child[node] + 1
    return node


def oracle_posterior(forest: Forest, x: np.ndarray) -> np.ndarray:
    out = np.zeros(forest.leaf_hist.shape[2:], dtype=np.float64)
    for t in range(forest.num_trees):
        view = forest.tree_view(t)
        leaf = oracle_find_leaf(view, x)
        out += view.leaf_hist[leaf]
    return out.astype(np.float32)


@pytest.fixture(scope="module")
def small_forest():
    rng = np.random.default_rng(0)
    return random_forest(rng, num_trees=4, depth=6, num_features=20,
                         class_counts=[8, 9])


class TestInference:
    def test_matches_oracle(self, small_forest):
        rng = np.random.default_rng(1)
        x = rng.normal(size=(257, 20)).astype(np.float32)
        pred = ForestPredictor(small_forest)
        got = np.asarray(pred.log_posterior(jnp.asarray(x)))
        want = np.stack([oracle_posterior(small_forest, xi) for xi in x])
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    def test_leaves_match_oracle(self, small_forest):
        rng = np.random.default_rng(2)
        x = rng.normal(size=(64, 20)).astype(np.float32)
        pred = ForestPredictor(small_forest)
        got = np.asarray(pred.leaves(jnp.asarray(x)))
        for t in range(small_forest.num_trees):
            view = small_forest.tree_view(t)
            want = np.array([oracle_find_leaf(view, xi) for xi in x])
            np.testing.assert_array_equal(got[:, t], want)

    def test_single_node_tree(self):
        # A tree that never split: root is the only (leaf) node.
        tree = TreeArrays(
            split_feature=np.zeros(1, np.int32),
            threshold=np.zeros(1, np.float32),
            left_child=np.zeros(1, np.int32),
            leaf_hist=np.array([[[0.5, -0.5]]], np.float32),
        )
        forest = build_forest([tree], [2])
        pred = ForestPredictor(forest)
        out = np.asarray(pred.log_posterior(jnp.zeros((3, 4))))
        np.testing.assert_allclose(out, np.tile([[[0.5, -0.5]]], (3, 1, 1)))

    def test_threshold_boundary_goes_right(self):
        # classifier.cpp:105: strictly-less goes left; equality goes right.
        tree = TreeArrays(
            split_feature=np.array([0, 0, 0], np.int32),
            threshold=np.array([1.0, 0, 0], np.float32),
            left_child=np.array([1, 0, 0], np.int32),
            leaf_hist=np.stack(
                [np.zeros((1, 2)), [[1.0, 0]], [[0, 1.0]]]
            ).astype(np.float32),
        )
        forest = build_forest([tree], [2])
        pred = ForestPredictor(forest)
        x = jnp.array([[0.999], [1.0], [1.001]])
        leaves = np.asarray(pred.leaves(x))[:, 0]
        np.testing.assert_array_equal(leaves, [1, 2, 2])


class TestBinaryCodec:
    def test_roundtrip_via_reference_format(self, small_forest, tmp_path):
        path = str(tmp_path / "forest.dat")
        save_forest(path, small_forest)
        loaded = load_forest(path)
        assert loaded.num_trees == small_forest.num_trees
        assert loaded.class_counts == small_forest.class_counts
        assert loaded.max_depth == small_forest.max_depth
        # Predictions identical after a round-trip.
        rng = np.random.default_rng(3)
        x = jnp.asarray(rng.normal(size=(50, 20)).astype(np.float32))
        p1 = np.asarray(ForestPredictor(small_forest).log_posterior(x))
        p2 = np.asarray(ForestPredictor(loaded).log_posterior(x))
        np.testing.assert_allclose(p1, p2, rtol=1e-6)

    def test_exact_byte_layout(self):
        # Hand-build the byte stream the C++ writer would emit for a tiny
        # forest and check the decoder (io.h:34-108, classifier.cpp:134-235).
        import struct

        buf = io.BytesIO()
        buf.write(struct.pack("<i", 1))  # tree count
        buf.write(struct.pack("<i", 3))  # splitFeatures
        buf.write(struct.pack("<3i", 2, 0, 0))
        buf.write(struct.pack("<i", 3))  # thresholds
        buf.write(struct.pack("<3f", 0.5, 0.0, 0.0))
        buf.write(struct.pack("<i", 3))  # leftChild
        buf.write(struct.pack("<3i", 1, 0, 0))
        # histograms: 3 empty vectors (multi-label training leaves these
        # empty, learning.cpp:529/611 commented out)
        buf.write(struct.pack("<i", 3))
        for _ in range(3):
            buf.write(struct.pack("<i", 0))
        # multi_histograms: root empty, two leaves with 2 layers (2, 3 classes)
        buf.write(struct.pack("<i", 3))
        buf.write(struct.pack("<i", 0))
        for leaf in range(2):
            buf.write(struct.pack("<i", 2))
            buf.write(struct.pack("<i", 2))
            buf.write(struct.pack("<2f", leaf + 0.1, leaf + 0.2))
            buf.write(struct.pack("<i", 3))
            buf.write(struct.pack("<3f", leaf + 0.3, leaf + 0.4, leaf + 0.5))
        raw = buf.getvalue()

        forest = load_forest(raw)
        assert forest.num_trees == 1
        assert forest.class_counts == (2, 3)
        assert forest.node_counts == (3,)
        assert forest.max_depth == 1
        np.testing.assert_allclose(
            forest.leaf_hist[0, 1, 0, :2], [0.1, 0.2], rtol=1e-6
        )
        np.testing.assert_allclose(
            forest.leaf_hist[0, 2, 1, :3], [1.3, 1.4, 1.5], rtol=1e-6
        )
        # And the writer reproduces the identical byte stream.
        trees = read_reference_forest(io.BytesIO(raw))
        out = io.BytesIO()
        write_reference_forest(out, trees)
        assert out.getvalue() == raw

    def test_single_label_forest(self, tmp_path):
        tree = TreeArrays(
            split_feature=np.array([0, 0, 0], np.int32),
            threshold=np.array([0.5, 0, 0], np.float32),
            left_child=np.array([1, 0, 0], np.int32),
            leaf_hist=np.array(
                [[[0.0, 0.0]], [[1.0, 2.0]], [[3.0, 4.0]]], np.float32
            ),
        )
        forest = build_forest([tree], [2], multi_label=False)
        path = str(tmp_path / "single.dat")
        save_forest(path, forest)
        loaded = load_forest(path)
        assert not loaded.multi_label
        assert loaded.class_counts == (2,)
        np.testing.assert_allclose(loaded.leaf_hist[0, 1, 0], [1.0, 2.0])


class TestSumLeafHistograms:
    """``_sum_leaf_histograms`` gathers each tree's leaf row and sums over
    trees: equal to a NumPy loop over points and trees."""

    @pytest.mark.parametrize("points,seed", [(257, 7), (1, 3)])
    def test_matches_numpy_loop(self, small_forest, points, seed):
        from rovinasemanticsegmentation_tpu.models.forest import (
            _sum_leaf_histograms,
        )

        rng = np.random.default_rng(seed)
        hist = np.asarray(small_forest.leaf_hist)
        t, n = hist.shape[:2]
        leaves = rng.integers(0, n, size=(points, t), dtype=np.int32)
        got = np.asarray(
            _sum_leaf_histograms(jnp.asarray(hist), jnp.asarray(leaves))
        )
        want = np.zeros((points,) + hist.shape[2:], np.float32)
        for p in range(points):
            for k in range(t):
                want[p] += hist[k, leaves[p, k]]
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)

"""Cross-parity against the REFERENCE libforest, compiled in-env.

This closes the loop the codec unit tests cannot: a ``forest.dat`` produced
by the ORIGINAL C++ (classifier.cpp:210-235 via io.h:34-108) is cross-loaded
by the JAX rebuild, per-point log-posteriors are compared against the
original ``classLogPosterior``/``multiClassLogPosterior``
(classifier.cpp:119-131,166-208), and the breadth-first device trainer is
compared trainer-vs-trainer on a held-out split against the original
DecisionTreeLearner/RandomForestLearner (learning.cpp:363-1113).

The reference sources are compiled unmodified; only a 47-line
``boost/tokenizer.hpp`` stand-in (tests/cpp_parity/boost/) satisfies the
lone Boost include in data.cpp:6, and ``-include algorithm -include random``
supply headers older libstdc++ pulled in transitively.
"""

import os
import struct
import subprocess

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_LIBFOREST = "/root/reference/third-party/libforest"
DRIVER_SRC = os.path.join(REPO, "tests", "cpp_parity", "driver.cpp")


# ---------------------------------------------------------------------------
# Build fixture: compile the reference libforest + driver once per session.
# ---------------------------------------------------------------------------


@pytest.fixture(scope="session")
def driver(tmp_path_factory):
    if not os.path.isdir(REF_LIBFOREST):
        pytest.skip("reference libforest not present")
    out = tmp_path_factory.mktemp("cpp_parity") / "driver"
    cmd = [
        "g++",
        "-O2",
        "-std=c++11",
        "-fopenmp",
        "-msse4.2",
        "-include",
        "algorithm",
        "-include",
        "random",
        "-I",
        os.path.join(REF_LIBFOREST, "include"),
        "-I",
        os.path.join(REPO, "tests", "cpp_parity"),
        DRIVER_SRC,
        os.path.join(REF_LIBFOREST, "src", "classifier.cpp"),
        os.path.join(REF_LIBFOREST, "src", "data.cpp"),
        os.path.join(REF_LIBFOREST, "src", "learning.cpp"),
        os.path.join(REF_LIBFOREST, "src", "tools.cpp"),
        "-o",
        str(out),
    ]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.skip(f"reference libforest does not compile here: {proc.stderr[-500:]}")
    return str(out)


# ---------------------------------------------------------------------------
# Raw binary dataset interchange (the driver's ad-hoc format).
# ---------------------------------------------------------------------------


def write_raw(path, x, y):
    x = np.ascontiguousarray(x, dtype=np.float32)
    y = np.ascontiguousarray(y, dtype=np.int32)
    if y.ndim == 1:
        y = y[:, None]
    with open(path, "wb") as f:
        f.write(struct.pack("<3i", x.shape[0], x.shape[1], y.shape[1]))
        f.write(x.tobytes())
        f.write(y.tobytes())


def read_posteriors(path):
    """Returns list of [N, C_l] arrays, one per layer."""
    with open(path, "rb") as f:
        n, l = struct.unpack("<2i", f.read(8))
        counts = struct.unpack(f"<{l}i", f.read(4 * l))
        flat = np.frombuffer(f.read(), dtype=np.float32)
    per_point = sum(counts)
    assert flat.size == n * per_point
    flat = flat.reshape(n, per_point)
    out, off = [], 0
    for c in counts:
        out.append(flat[:, off : off + c].copy())
        off += c
    return out


def synthetic_dataset(rng, n, d=12, counts=(4, 3)):
    """Learnable multi-layer labels: noisy linear scores over the features."""
    x = rng.normal(size=(n, d)).astype(np.float32)
    ys = []
    for li, c in enumerate(counts):
        w = rng.normal(size=(d, c))
        logits = x @ w + 0.5 * rng.normal(size=(n, c))
        ys.append(np.argmax(logits, axis=1))
    return x, np.stack(ys, axis=1).astype(np.int32)


# ---------------------------------------------------------------------------
# Tests
# ---------------------------------------------------------------------------


class TestCrossLoad:
    def _train_cpp(self, driver, tmp_path, x, y, trees=3, depth=8, minsplit=10):
        data = tmp_path / "data.bin"
        forest = tmp_path / "forest.dat"
        write_raw(data, x, y)
        proc = subprocess.run(
            [driver, "train", str(data), str(forest), str(trees), str(depth), str(minsplit)],
            capture_output=True,
            text=True,
            check=True,
        )
        secs = [
            float(ln.split()[1])
            for ln in proc.stdout.splitlines()
            if ln.startswith("TRAIN_SECONDS")
        ]
        return str(forest), secs[0]

    def _predict_cpp(self, driver, tmp_path, forest, x, l):
        data = tmp_path / "query.bin"
        post = tmp_path / "post.bin"
        write_raw(data, x, np.zeros((len(x), l), np.int32))
        subprocess.run(
            [driver, "predict", forest, str(data), str(post)],
            capture_output=True,
            text=True,
            check=True,
        )
        return read_posteriors(str(post))

    def test_multi_label_cross_load_and_posterior_parity(self, driver, tmp_path):
        from rovinasemanticsegmentation_tpu.models.forest import (
            ForestPredictor,
            load_forest,
        )

        rng = np.random.default_rng(7)
        x, y = synthetic_dataset(rng, 4000, d=12, counts=(4, 3))
        forest_path, _ = self._train_cpp(driver, tmp_path, x, y)

        # (a) the C++-written forest.dat cross-loads (both decode paths).
        forest_native = load_forest(forest_path, use_native=True)
        forest_py = load_forest(forest_path, use_native=False)
        assert forest_native.num_trees == forest_py.num_trees == 3
        assert forest_native.num_layers == 2
        assert tuple(forest_native.class_counts) == (4, 3)
        for t in range(forest_native.num_trees):
            a, b = forest_native.tree_view(t), forest_py.tree_view(t)
            np.testing.assert_array_equal(a.split_feature, b.split_feature)
            np.testing.assert_array_equal(a.threshold, b.threshold)
            np.testing.assert_array_equal(a.left_child, b.left_child)
            np.testing.assert_array_equal(a.leaf_hist, b.leaf_hist)

        # (b) per-point multiClassLogPosterior parity on unseen queries
        # (classifier.cpp:187-208: sum of per-tree per-layer leaf log-hists).
        xq = rng.normal(size=(1500, 12)).astype(np.float32)
        want = self._predict_cpp(driver, tmp_path, forest_path, xq, 2)
        got = np.asarray(ForestPredictor(forest_native).log_posterior(xq))
        assert got.shape == (1500, 2, 4)  # layer-padded to C_max
        np.testing.assert_allclose(got[:, 0, :4], want[0], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got[:, 1, :3], want[1], rtol=1e-6, atol=1e-6)

    def test_single_label_cross_load_and_posterior_parity(self, driver, tmp_path):
        from rovinasemanticsegmentation_tpu.models.forest import (
            ForestPredictor,
            load_forest,
        )

        rng = np.random.default_rng(3)
        x, y = synthetic_dataset(rng, 3000, d=10, counts=(5,))
        forest_path, _ = self._train_cpp(driver, tmp_path, x, y[:, 0:1], trees=2)

        forest = load_forest(forest_path)
        assert forest.num_trees == 2 and forest.num_layers == 1
        xq = rng.normal(size=(1000, 10)).astype(np.float32)
        want = self._predict_cpp(driver, tmp_path, forest_path, xq, 1)
        got = np.asarray(ForestPredictor(forest).log_posterior(xq))
        np.testing.assert_allclose(got[:, 0, :5], want[0], rtol=1e-6, atol=1e-6)

    def test_roundtrip_reencode_is_byte_identical(self, driver, tmp_path):
        """Decode the C++ bytes and re-encode: the files must be identical —
        the strongest possible codec check (io.h:34-108)."""
        from rovinasemanticsegmentation_tpu.models.forest import (
            read_reference_forest,
            write_reference_forest,
        )
        import io

        rng = np.random.default_rng(11)
        x, y = synthetic_dataset(rng, 2000, d=8, counts=(3, 4))
        forest_path, _ = self._train_cpp(driver, tmp_path, x, y, trees=2, depth=6)
        blob = open(forest_path, "rb").read()
        buf = io.BytesIO()
        write_reference_forest(buf, read_reference_forest(io.BytesIO(blob)))
        assert buf.getvalue() == blob

    @pytest.mark.slow
    def test_trainer_vs_trainer_heldout_accuracy(self, driver, tmp_path):
        """(c) the breadth-first device learner reaches the C++ learner's
        held-out accuracy on the same data (learning.cpp:412-662 vs
        train/forest_trainer.py); split choices differ (random layers,
        bootstrap), so compare metrics, not trees."""
        from rovinasemanticsegmentation_tpu.models.forest import ForestPredictor
        from rovinasemanticsegmentation_tpu.train.forest_trainer import (
            ForestTrainer,
            TrainerConfig,
        )

        rng = np.random.default_rng(5)
        x, y = synthetic_dataset(rng, 8000, d=12, counts=(4, 3))
        xtr, ytr, xte, yte = x[:6000], y[:6000], x[6000:], y[6000:]

        forest_path, cpp_secs = self._train_cpp(
            driver, tmp_path, xtr, ytr, trees=4, depth=10, minsplit=10
        )
        cpp_post = self._predict_cpp(driver, tmp_path, forest_path, xte, 2)
        cpp_acc = [
            float((np.argmax(cpp_post[li], axis=1) == yte[:, li]).mean())
            for li in range(2)
        ]

        trainer = ForestTrainer(
            TrainerConfig(num_trees=4, max_depth=10, min_split_examples=10)
        )
        ours = trainer.learn(xtr, ytr, class_counts=[4, 3], progress=False)
        got = np.asarray(ForestPredictor(ours).log_posterior(xte))
        our_acc = [
            float((np.argmax(got[:, li, : (4, 3)[li]], axis=1) == yte[:, li]).mean())
            for li in range(2)
        ]
        print(f"cpp acc={cpp_acc} ({cpp_secs:.2f}s 8-thread) ours acc={our_acc}")
        for li in range(2):
            assert our_acc[li] >= cpp_acc[li] - 0.03, (li, our_acc, cpp_acc)

"""Train the bench fixture forest (VERDICT round-1 item #3).

A ``random_forest`` with N(0,1) thresholds on random features has a
leaf-depth distribution no trained forest has, and the descent's cost
follows that distribution, so the bench runs a forest that was actually
trained. This script:

1. renders synthetic indoor-style RGB-D frames (same generator as bench.py),
2. extracts real 366-dim features at the reference's training stride 5
   (``/root/reference/resources/config.json:33``),
3. derives two label layers from scene geometry + color (heuristics shaped
   like the reference's material/object layers, cf. the floor/wall/ceiling
   stub ``/root/reference/scripts/single_frame_segmentation_server.py:12-52``),
4. trains 4 trees, depth <= 30, minSplit 50 (reference config defaults,
   ``resources/config.json:37-39``) with the production trainer,
5. writes ``resources/bench_forest.dat`` in the reference binary format.

Run once (``python scripts/make_bench_forest.py``); bench.py and
chip_smoke.py load the fixture.
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

H, W = 480, 640
TRAIN_STRIDE = 5
N_FRAMES = 12


def make_rgb(r, depth):
    """Color loosely correlated with depth structure (smooth + patches)."""
    base = (depth.astype(np.float32) / 15500.0 * 200.0)[..., None]
    rgb = base + r.normal(0, 20, (H, W, 3))
    for _ in range(8):
        y0, x0 = r.integers(0, H - 60), r.integers(0, W - 80)
        bh, bw = r.integers(40, 160), r.integers(60, 200)
        rgb[y0 : y0 + bh, x0 : x0 + bw] += r.uniform(-80, 80, 3)
    return np.clip(rgb, 0, 255).astype(np.uint8)


def main() -> None:
    from rovinasemanticsegmentation_tpu.utils.compile_cache import (
        setup_compile_cache,
    )

    setup_compile_cache()

    from rovinasemanticsegmentation_tpu.features.extractor import (
        ExtractType,
        FeatureConfig,
        FeatureExtractor,
    )
    from rovinasemanticsegmentation_tpu.models.forest import save_forest
    from rovinasemanticsegmentation_tpu.train.forest_trainer import (
        ForestTrainer,
        TrainerConfig,
    )
    from rovinasemanticsegmentation_tpu.utils.synthetic import (
        make_depth,
        vga_calibration,
    )

    rng = np.random.default_rng(42)
    calib = vga_calibration(H, W)
    extractor = FeatureExtractor(FeatureConfig())

    feats_all, labels_all = [], []
    for fi in range(N_FRAMES):
        depth = make_depth(rng, H, W)
        rgb = make_rgb(rng, depth)

        # Material layer (8 classes) from geometry: height bands + depth
        # bands; object layer (9 classes) from color + local structure.
        z = depth.astype(np.float32) / 1000.0
        ys = np.mgrid[0:H, 0:W][0]
        height_proxy = (ys.astype(np.float32) / H) * z  # world-ish z
        mat = np.clip((height_proxy / 6.0 * 8.0).astype(np.int64), 0, 7)
        obj = np.clip((rgb.astype(np.int64).sum(-1) // 96), 0, 8)
        mat[depth == 0] = -1
        obj[depth == 0] = -1

        batch = extractor.extract(
            rgb, depth, calib, stride=TRAIN_STRIDE,
            label_extraction=ExtractType.WITH_POSITIVE_LABEL,
            labels=[mat.astype(np.int8), obj.astype(np.int8)],
        )
        mask = np.asarray(batch.mask)
        feats_all.append(np.asarray(batch.features)[mask])
        labels_all.append(np.asarray(batch.labels)[mask])
        print(f"frame {fi}: {int(mask.sum())} labeled samples")

    feats = np.concatenate(feats_all)
    labels = np.concatenate(labels_all)
    print(f"training on {len(feats)} samples x {feats.shape[1]} features")

    cfg = TrainerConfig(num_trees=4, max_depth=30, min_split_examples=50)
    t0 = time.perf_counter()
    forest = ForestTrainer(cfg).learn(
        feats, labels, class_counts=[8, 9], progress=True
    )
    print(f"trained in {time.perf_counter() - t0:.1f}s; "
          f"nodes per tree: {forest.node_counts}")

    out = os.path.join(os.path.dirname(__file__), "..", "resources",
                       "bench_forest.dat")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    save_forest(out, forest)
    print(f"wrote {out} ({os.path.getsize(out)} bytes)")


if __name__ == "__main__":
    main()

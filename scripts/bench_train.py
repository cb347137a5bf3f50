"""Forest-training throughput on one GPU.

The reference's training instrument is "Finished forest in N s" over 8 CPU
threads (/root/reference/third-party/libforest/src/learning.cpp:1105,
/root/reference/src/train.cpp:239). This measures the device trainer
(breadth-first batched exact split search, train/forest_trainer.py) on a
synthetic multi-label dataset shaped like one training run's worth of
extracted features.

Usage: python scripts/bench_train.py [n_points] [n_trees] [split_bins]
split_bins > 0 selects the sort-free binned device split search
(TrainerConfig.split_bins; 0 = exact sort-based mode).
Prints one JSON line {"metric": "train_points_per_sec", ...} with the
device and the card's name and power limit. Needs a GPU.
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> None:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000
    trees = int(sys.argv[2]) if len(sys.argv) > 2 else 4
    bins = int(sys.argv[3]) if len(sys.argv) > 3 else 0

    from rovinasemanticsegmentation_tpu.utils.compile_cache import (
        setup_compile_cache,
    )
    from rovinasemanticsegmentation_tpu.utils.device import (
        card_label,
        require_gpu,
    )

    device = require_gpu()
    card = card_label()
    # The trainer's level steps span ~20 bucketed shapes.
    setup_compile_cache()

    from rovinasemanticsegmentation_tpu.train.forest_trainer import (
        ForestTrainer,
        TrainerConfig,
    )

    rng = np.random.default_rng(0)
    d = 366
    feats = rng.normal(size=(n, d)).astype(np.float32)
    # Labels correlated with features so splits do real work.
    labels = np.stack(
        [
            (feats[:, :8].argmax(axis=1)).astype(np.int32),
            (feats[:, 8:17].argmax(axis=1)).astype(np.int32),
        ],
        axis=1,
    )
    cfg = TrainerConfig(
        num_trees=trees, max_depth=30, min_split_examples=50,
        split_bins=bins,
    )
    trainer = ForestTrainer(cfg)

    # Cold pass: includes every compile (bins, growth while_loop, refit). Warm pass: a SECOND learn() at a different seed — same
    # executables from the in-process jit cache, fresh tree growth — the
    # number comparable to the reference's "Finished forest in N s"
    # (its binary has no compile stage).
    start = time.perf_counter()
    forest = trainer.learn(
        feats, labels, class_counts=[8, 9], progress=False
    )
    cold = time.perf_counter() - start
    cfg2 = TrainerConfig(
        num_trees=trees, max_depth=30, min_split_examples=50,
        split_bins=bins, seed=17,
    )
    trainer2 = ForestTrainer(cfg2)
    start = time.perf_counter()
    forest = trainer2.learn(
        feats, labels, class_counts=[8, 9], progress=False
    )
    elapsed = time.perf_counter() - start
    nodes = sum(
        len(forest.tree_view(t).split_feature) for t in range(trees)
    )
    print(
        json.dumps(
            {
                "metric": "train_points_per_sec",
                "value": round(n * trees / elapsed, 1),
                "unit": f"point-trees/s ({trees} trees, {n} pts, "
                f"{nodes} nodes, warm {elapsed:.1f}s, cold {cold:.1f}s, "
                f"bins={bins})",
                "device": device,
                "card": card,
            }
        )
    )


if __name__ == "__main__":
    main()

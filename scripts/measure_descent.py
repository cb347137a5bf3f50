"""Time the forest descent kernel against the plain XLA loop on the GPU.

Alone (the extracted features of B VGA keyframes at stride 2, the trained
4-tree fixture forest) at four block sizes, and end to end through the
batched frame path in xla / triton / triton / xla order.

Usage: python scripts/measure_descent.py [--batch 5] [--reps 10]
       [--out descent.json]

Needs a GPU. Prints one JSON object per measurement, each with the card's
name and power limit, and with ``--out`` writes them all to that file.
"""

import argparse
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from rovinasemanticsegmentation_tpu.utils.compile_cache import (  # noqa: E402
    setup_compile_cache,
)
from rovinasemanticsegmentation_tpu.utils.device import (  # noqa: E402
    card_label,
    require_gpu,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RECORDS = []


def emit(record):
    record["card"] = CARD
    RECORDS.append(record)
    print(json.dumps(record), flush=True)


def timed(fn, reps):
    """(median ms, all ms) of ``fn()`` whose result is blocked on; the
    first call (compilation) is timed separately."""
    t0 = time.perf_counter()
    jax.block_until_ready(fn())
    compile_ms = (time.perf_counter() - t0) * 1e3
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times), times, compile_ms


def main():
    global CARD
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=5)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    setup_compile_cache()
    device = require_gpu()
    CARD = card_label()
    print(f"device {device} card {CARD}", flush=True)

    from rovinasemanticsegmentation_tpu.features.extractor import (
        FeatureConfig,
        _extract_impl,
    )
    from rovinasemanticsegmentation_tpu.models.forest import (
        _find_leaves_packed,
        load_forest,
    )
    from rovinasemanticsegmentation_tpu.ops.forest_pallas import (
        find_leaves_triton,
    )
    from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
        SingleFramePipeline,
    )
    from rovinasemanticsegmentation_tpu.utils.synthetic import (
        make_frames,
        vga_calibration,
    )

    b, reps = args.batch, args.reps
    rng = np.random.default_rng(0)
    forest = load_forest(
        os.path.join(ROOT, "resources", "bench_forest.dat"), class_counts=[8, 9]
    )
    cfg = FeatureConfig()
    calib = vga_calibration()
    frames = make_frames(rng, b)
    rgb = jnp.asarray(np.stack([f[0] for f in frames]))
    depth = jnp.asarray(np.stack([f[1] for f in frames]))
    kinv = jnp.asarray(np.tile(calib.intrinsic_inverse[None], (b, 1, 1)), jnp.float32)
    rot = jnp.asarray(np.tile(np.eye(3)[None], (b, 1, 1)), jnp.float32)
    trans = jnp.zeros((b, 3), jnp.float32)

    def frame_path(descent):
        pipe = SingleFramePipeline(cfg, forest, stride=2, fill_value=0.0,
                                   descent=descent)

        def run():
            out = pipe.run_batch_stacked(rgb, depth, kinv, rot, trans)
            return [r.labels for r in out]

        return run

    def e2e(descent):
        jax.clear_caches()
        med, all_ms, compile_ms = timed(frame_path(descent), reps)
        emit({"what": "descent", "variant": descent, "scope": "frame path",
              "batch": b, "ms_per_batch": med, "ms_per_kf": med / b,
              "ms_all": all_ms, "first_call_ms": compile_ms})

    feats = jax.jit(jax.vmap(
        lambda r, d, k, ro, t: _extract_impl(
            r, d, k, ro, t, jnp.float32(cfg.d_min), jnp.float32(cfg.d_max),
            stride=2, patch_size=cfg.patch_size,
            reduce_size=cfg.patch_size_reduce, use_color_patch=True,
            use_depth=True, use_height=True, use_normal=True,
        )[0]
    ))(rgb, depth, kinv, rot, trans)
    feats = feats.reshape(-1, feats.shape[-1])
    from rovinasemanticsegmentation_tpu.models.forest import ForestPredictor

    pred = ForestPredictor(forest)
    want = np.asarray(_find_leaves_packed(
        feats, pred.records, pred.max_depth, pred.feat_bits))
    med, all_ms, c = timed(lambda: _find_leaves_packed(
        feats, pred.records, pred.max_depth, pred.feat_bits), reps)
    emit({"what": "descent", "variant": "xla", "scope": "kernel",
          "points": int(feats.shape[0]), "ms": med, "ms_all": all_ms})
    for block, warps in ((32, 1), (64, 2), (128, 4), (256, 8)):
        fn = lambda: find_leaves_triton(  # noqa: E731
            feats, pred.records, pred.max_depth, pred.feat_bits,
            block=block, num_warps=warps)
        got = np.asarray(fn())
        med, all_ms, c = timed(fn, reps)
        emit({"what": "descent", "variant": f"triton b{block} w{warps}",
              "scope": "kernel", "points": int(feats.shape[0]), "ms": med,
              "ms_all": all_ms, "exact": bool((got == want).all())})
    for descent in ("xla", "triton", "triton", "xla"):
        e2e(descent)

    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"device": device, "card": CARD, "records": RECORDS}, f,
                      indent=1)


if __name__ == "__main__":
    main()

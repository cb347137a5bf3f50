"""Smoke run of the online segmentation path on one GPU.

    python chip_smoke.py [--seed N]

Drives the served path once through the entry points a user calls: a
``Segmenter`` with the reference deployment's settings (VGA keyframes at
``rf_prediction_stride`` 2, 77 -> 11 colour patches, 366 features, the
trained 4-tree fixture forest, dense CRF with 10 iterations) behind
``SegmentationServiceServer``. Ten seeded keyframes and two local maps of
30,000 points go in through ``push_color``/``push_depth``/``on_new_node``/
``on_new_local_map``; the HTTP services are then queried with ``urllib``.

The GPU's results are compared with the plain reference run in the same
process on the CPU backend: Lab and patches byte-exact, the descent
kernel's leaves exact on the same feature matrix, float features within
stated tolerances, frame labels and (from the served frame posteriors)
map labels above measured agreement fractions. The native host library
must have been built and loaded.

Exits non-zero if JAX finds no GPU or any phase fails. The last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

import argparse
import json
import os
import time
import urllib.request

# The CPU backend carries the reference run; keep it available beside the GPU.
_platforms = os.environ.get("JAX_PLATFORMS")
if _platforms and "cpu" not in _platforms.split(","):
    os.environ["JAX_PLATFORMS"] = _platforms + ",cpu"

import numpy as np  # noqa: E402

ROOT = os.path.dirname(os.path.abspath(__file__))
N_KEYFRAMES = 10
MAP_EVERY = 5
MAP_POINTS = 30000
STRIDE = 2
POSE_STEP = 0.1  # m between keyframes: above the 0.07 m keyframe gate
CLASSES = {"material": 8, "object": 9}  # the fixture forest's two layers

# Tolerances of the GPU against the CPU reference, measured on an H100:
# Lab, patches and leaves are integer pipelines and must match exactly.
# Depth is an exact integer conversion; height is a float32 product that
# may round differently; the normal angle is an acos of sums taken in
# another order, and where the depth-change test sits on its threshold a
# pixel may switch between a normal and the invalid value -2.
HEIGHT_ATOL = 1e-5
NORMAL_ATOL = 0.02  # rad; the largest difference measured was 0.0084
NORMAL_MAX_OFF = 1e-4  # share of points allowed beyond it (a -2 switch)
# Labels. Frames: the leaves are exact, only the bilinear resize and the
# argmax of float posteriors remain. Maps: the CPU map path gets the GPU's
# served frame posteriors, so only the map path's own float rounding
# differs (fusion's projection, the lattice embedding, the CRF's sums and
# exponentials); a point whose rounding moves it to another lattice
# vertex, or whose top class sits at the 2/C confidence floor, may change
# label. On the CPU, one ulp in the map points changes at most 4 of 30,000
# labels per layer.
FRAME_AGREEMENT = 0.999
MAP_AGREEMENT = 0.999


def reference_config():
    """The reference node's config schema (resources/config.json keys)."""
    codings = []
    for name, count in CLASSES.items():
        coding = [
            {"name": f"{name}{i}", "color": [i * 20, 255 - i * 20, 40],
             "label": i}
            for i in range(count - 1)
        ]
        coding.append({"name": "Unknown", "color": [50, 50, 50],
                       "label": count - 1})
        coding.append({"name": "Void", "color": [0, 0, 0], "label": -1})
        codings.append({"name": name, "coding": coding})
    return {
        "root_dir": "",
        "color_codings": codings,
        "use_dense_crf": True,
        "dcrf_xyz_kernel": 0.5,
        "dcrf_rgb_kernel": 4.0,
        "dcrf_kernel_weight": 10.0,
        "dcrf_iterations": 10,
        "rf_prediction_stride": STRIDE,
        "depth_min": 0.5,
        "depth_max": 15.0,
        "keyframe_skip_rotation": 0.1,
        "keyframe_skip_translation": 0.07,
        "patch_size": 77,
        "patch_size_reduce": 11,
        "feature_color_patch": True,
        "feature_depth": True,
        "feature_height": True,
        "feature_normal": True,
    }


def result_line(device):
    """The last line: ok and the device as JAX reports it."""
    return json.dumps({
        "ok": True,
        "device": {
            "platform": device["platform"],
            "kind": device["kind"],
            "count": device["count"],
        },
    })


def pose(i):
    p = np.eye(4, dtype=np.float32)
    p[0, 3] = POSE_STEP * i
    return p


def http(server, path, body=None):
    req = urllib.request.Request(
        server.address + path,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"},
    )
    with urllib.request.urlopen(req, timeout=60) as resp:
        return json.loads(resp.read())


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)
    print(f"ok: {msg}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the synthetic keyframes and maps")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from rovinasemanticsegmentation_tpu.utils.device import (
        gpu_query_text,
        require_gpu,
    )

    print("devices:", jax.devices(), flush=True)
    device = require_gpu()
    print(f"platform {device['platform']} kind {device['kind']} "
          f"count {device['count']}", flush=True)
    smi = gpu_query_text()
    print(smi, flush=True)
    card = smi.splitlines()[0]

    from rovinasemanticsegmentation_tpu.utils.compile_cache import (
        setup_compile_cache,
    )

    setup_compile_cache()

    from rovinasemanticsegmentation_tpu import native

    lib = native.get_lib()
    check(lib is not None, f"native host library loaded ({native.lib_path()})")

    from rovinasemanticsegmentation_tpu.features.extractor import _extract_impl
    from rovinasemanticsegmentation_tpu.fusion.projector import MultiProjector
    from rovinasemanticsegmentation_tpu.models.forest import (
        _find_leaves_packed,
    )
    from rovinasemanticsegmentation_tpu.ops.color import rgb_to_lab8
    from rovinasemanticsegmentation_tpu.ops.forest_pallas import (
        find_leaves_triton,
    )
    from rovinasemanticsegmentation_tpu.ops.patches import (
        extract_patches_grid,
        reflect_pad_image,
    )
    from rovinasemanticsegmentation_tpu.pipelines.local_map import (
        CrfParams,
        LocalMapPipeline,
        MapNodeFrames,
    )
    from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
        ARGMAX_FLOOR,
        SingleFramePipeline,
    )
    from rovinasemanticsegmentation_tpu.serve.segmenter import (
        LocalMapData,
        MapNode,
        Segmenter,
    )
    from rovinasemanticsegmentation_tpu.serve.services import (
        SegmentationServiceServer,
    )
    from rovinasemanticsegmentation_tpu.utils.config import Config
    from rovinasemanticsegmentation_tpu.utils.synthetic import (
        make_cloud,
        make_frames,
        vga_calibration,
    )

    cpu = jax.devices("cpu")[0]
    rng = np.random.default_rng(args.seed)
    print(f"seed {args.seed}", flush=True)
    frames = make_frames(rng, N_KEYFRAMES)
    h, w = frames[0][1].shape
    calib = vga_calibration(h, w)
    clouds = [
        make_cloud(
            rng, frames[m * MAP_EVERY:(m + 1) * MAP_EVERY], MAP_POINTS,
            offsets=[pose(i)[:3, 3] for i in
                     range(m * MAP_EVERY, (m + 1) * MAP_EVERY)],
        )
        for m in range(N_KEYFRAMES // MAP_EVERY)
    ]

    # ---- the served path on the GPU
    seg = Segmenter(
        Config(data=reference_config()),
        topic_names=["/camera_front/rgb/image", "/camera_front/depth/image"],
        forest_path=os.path.join(ROOT, "resources", "bench_forest.dat"),
    )
    check(list(seg.layer_class_counts) == list(CLASSES.values()),
          f"segmenter layers {seg.layer_names} {seg.layer_class_counts}")
    check(seg._forest.num_trees == 4
          and 10347 <= min(seg._forest.node_counts)
          and max(seg._forest.node_counts) <= 10905,
          f"fixture forest: 4 trees, nodes {seg._forest.node_counts}")
    seg.initialize_projector(["camera_front"], [calib], (h, w))
    server = SegmentationServiceServer(seg)
    server.start()
    try:
        fp, mp = seg._frame_pipeline, seg._map_pipeline
        check(fp.descent == "triton", f"frame path descent {fp.descent}")

        # Compile outside the timed region: every batch size the worker's
        # ladder can take, and the map path's validating and fused forms.
        t0 = time.perf_counter()
        for b in seg._BATCH_LADDER:
            out = fp.run_batch([frames[0][0]] * b, [frames[0][1]] * b,
                               [calib] * b)
            jax.block_until_ready([r.labels for r in out])
        warm_nodes = [
            MapNodeFrames(pose=pose(i), posteriors=[list(out[0].posteriors)])
            for i in range(MAP_EVERY)
        ]
        mp.run(*clouds[0], warm_nodes)
        mp.run(*clouds[0], warm_nodes)
        print(f"warm-up (compilation) {time.perf_counter() - t0:.1f} s",
              flush=True)

        # Keyframes through the served path.
        t0 = time.perf_counter()
        for i, (rgb, depth) in enumerate(frames):
            seq = i + 1
            seg.push_color("camera_front", seq, rgb)
            seg.push_depth("camera_front", seq, depth)
            check(seg.on_new_node(MapNode(seq, pose(i), [seq])),
                  f"keyframe {seq} queued")
        deadline = time.monotonic() + 300
        while len(seg._result_queues[0]) < N_KEYFRAMES:
            if time.monotonic() > deadline:
                raise TimeoutError("frame worker did not finish")
            time.sleep(0.001)
        served_post = [post for _, post in list(seg._result_queues[0])]
        jax.block_until_ready(served_post)
        frame_s = time.perf_counter() - t0
        print(f"keyframes/s {N_KEYFRAMES / frame_s:.3f} "
              f"({N_KEYFRAMES} VGA keyframes in {frame_s * 1e3:.1f} ms) "
              f"on {card}", flush=True)

        # Local maps through the served path.
        t0 = time.perf_counter()
        for m, (pts, crgb) in enumerate(clouds):
            nodes = [
                MapNode(i + 1, pose(i), [i + 1])
                for i in range(m * MAP_EVERY, (m + 1) * MAP_EVERY)
            ]
            seg.on_new_local_map(LocalMapData(100 + m, nodes, pts, crgb))
        deadline = time.monotonic() + 300
        while len(seg.stored_semantics_ids()) < len(clouds):
            if time.monotonic() > deadline:
                raise TimeoutError("map worker did not finish")
            time.sleep(0.001)
        map_s = time.perf_counter() - t0
        mp.flush()
        print(f"ms per map {map_s * 1e3 / len(clouds):.3f} "
              f"({len(clouds)} maps of {MAP_POINTS} points) on {card}",
              flush=True)

        # The HTTP services.
        ids = http(server, "/semantic_segmentation/local_map_ids")
        check(ids["local_map_ids"] == [100, 101], f"map ids {ids}")
        info = http(server, "/semantic_segmentation/information")
        check(info["layer_names"] == list(CLASSES)
              and info["class_counts"] == list(CLASSES.values()),
              f"information {info['layer_names']} {info['class_counts']}")
        served_maps = []
        for m in range(len(clouds)):
            got = http(server, "/semantic_segmentation/get_local_map_segmentation",
                       {"local_map_id": 100 + m,
                        "segmentation_layers": list(CLASSES)})
            labels = np.asarray(got["point_labels"]).reshape(len(CLASSES), -1)
            check(got["local_map_id"] == 100 + m
                  and labels.shape == (len(CLASSES), MAP_POINTS),
                  f"map {100 + m}: {labels.shape[1]} labels per layer")
            for li, c in enumerate(CLASSES.values()):
                counts = np.bincount(labels[li], minlength=c)
                check(labels[li].min() >= 0 and labels[li].max() < c,
                      f"map {100 + m} layer {li} labels in [0, {c}), "
                      f"counts {counts.tolist()}")
            served_maps.append(labels)
    finally:
        server.stop()
        seg.stop()

    # ---- the plain reference on the CPU, at the same widths
    cfg = fp.feature_config
    rgb0, depth0 = frames[0]
    lab_gpu = np.asarray(rgb_to_lab8(jnp.asarray(rgb0)))
    with jax.default_device(cpu):
        lab_cpu = np.asarray(rgb_to_lab8(jnp.asarray(rgb0)))
    check((lab_gpu == lab_cpu).all(), "Lab byte-exact against the CPU")

    d_grid = depth0[::STRIDE, ::STRIDE].astype(np.float32) / 1000.0
    d_grid = np.where((d_grid >= cfg.d_min) & (d_grid <= cfg.d_max), d_grid, 0)
    kw = dict(patch_size=cfg.patch_size, reduce_size=cfg.patch_size_reduce,
              stride=STRIDE)

    def patches():
        padded = reflect_pad_image(rgb_to_lab8(jnp.asarray(rgb0)),
                                   cfg.patch_size)
        return np.asarray(extract_patches_grid(padded, jnp.asarray(d_grid), **kw))

    patches_gpu = patches()
    with jax.default_device(cpu):
        patches_cpu = patches()
    valid = d_grid > 0
    check((patches_gpu[valid] == patches_cpu[valid]).all(),
          f"patches byte-exact against the CPU ({int(valid.sum())} points)")

    def features(r, d):
        return _extract_impl(
            jnp.asarray(r), jnp.asarray(d),
            jnp.asarray(calib.intrinsic_inverse, jnp.float32),
            jnp.asarray(calib.rotation, jnp.float32),
            jnp.asarray(calib.translation, jnp.float32),
            jnp.float32(cfg.d_min), jnp.float32(cfg.d_max),
            stride=STRIDE, patch_size=cfg.patch_size,
            reduce_size=cfg.patch_size_reduce, use_color_patch=True,
            use_depth=True, use_height=True, use_normal=True,
        )[0]

    feats_gpu = features(rgb0, depth0)
    with jax.default_device(cpu):
        feats_cpu = np.asarray(features(rgb0, depth0))
    fg = np.asarray(feats_gpu)
    n_patch = 3 * cfg.patch_size_reduce ** 2
    check((fg[:, :n_patch] == feats_cpu[:, :n_patch]).all()
          and (fg[:, n_patch] == feats_cpu[:, n_patch]).all(),
          "patch and depth features exact against the CPU")
    height_err = np.abs(fg[:, n_patch + 1] - feats_cpu[:, n_patch + 1]).max()
    check(height_err <= HEIGHT_ATOL,
          f"height within {HEIGHT_ATOL} (max diff {height_err:.3g})")
    normal_err = np.abs(fg[:, n_patch + 2] - feats_cpu[:, n_patch + 2])
    off = float((normal_err > NORMAL_ATOL).mean())
    check(off <= NORMAL_MAX_OFF,
          f"normal angle within {NORMAL_ATOL} at all but {off:.2e} of "
          f"points (limit {NORMAL_MAX_OFF}); max diff {normal_err.max():.3g}")

    pred = fp.predictor
    leaves_gpu = np.asarray(find_leaves_triton(
        feats_gpu, pred.records, pred.max_depth, pred.feat_bits))
    with jax.default_device(cpu):
        leaves_cpu = np.asarray(_find_leaves_packed(
            jnp.asarray(fg), jnp.asarray(np.asarray(pred.records)),
            pred.max_depth, pred.feat_bits))
    check((leaves_gpu == leaves_cpu).all(),
          f"descent kernel leaves exact against the CPU "
          f"({leaves_gpu.shape[0]} points x {leaves_gpu.shape[1]} trees)")

    # Frame labels: the first map's five keyframes through the CPU frame
    # pipeline (plain XLA descent).
    with jax.default_device(cpu):
        ref_fp = SingleFramePipeline(cfg, seg._forest, stride=STRIDE,
                                     fill_value=0.0, descent="xla")
        ref_frames = ref_fp.run_batch(
            [f[0] for f in frames[:MAP_EVERY]],
            [f[1] for f in frames[:MAP_EVERY]], [calib] * MAP_EVERY)
        ref_frame_labels = [[np.asarray(l) for l in r.labels]
                            for r in ref_frames]
    # The served posteriors' labels, as _posterior_maps derives them.
    agree = np.mean([
        (np.where(p.max(-1) > ARGMAX_FLOOR, p.argmax(-1), -1) == r).mean()
        for post, rr in zip(served_post, ref_frame_labels)
        for p, r in zip((np.asarray(x) for x in post), rr)
    ])
    check(agree >= FRAME_AGREEMENT,
          f"frame labels agree with the CPU at {agree:.6f} of pixels "
          f"(limit {FRAME_AGREEMENT})")

    # Map labels: each map through the CPU map pipeline, fed the frame
    # posteriors the GPU served for its keyframes.
    with jax.default_device(cpu):
        proj = MultiProjector.from_calibrations(
            [calib], h, w, min_distance=0.5, max_distance=15.0)
        ref_mp = LocalMapPipeline(
            proj, list(CLASSES.values()), [c - 1 for c in CLASSES.values()],
            crf=CrfParams(use_dense_crf=True, xyz_kernel=0.5, rgb_kernel=4.0,
                          kernel_weight=10.0, iterations=10))
        ref_mp.run(*clouds[0], warm_nodes)  # the fused form, as served
        ref_maps = []
        for m, cloud in enumerate(clouds):
            keyframes = range(m * MAP_EVERY, (m + 1) * MAP_EVERY)
            ref_maps.append(ref_mp.run(*cloud, [
                MapNodeFrames(pose=pose(i), posteriors=[
                    [jnp.asarray(np.asarray(p)) for p in served_post[i]]])
                for i in keyframes
            ]))
        ref_mp.flush()
    agreements = []
    for m, (served_map, ref_map) in enumerate(zip(served_maps, ref_maps)):
        for li, unknown in enumerate(c - 1 for c in CLASSES.values()):
            served, ref = served_map[li], np.asarray(ref_map[li])
            differ = served != ref
            agreements.append((m, li, float(1.0 - differ.mean())))
            via_unknown = ((served == unknown) | (ref == unknown))[differ]
            print(f"map {100 + m} layer {li}: {int(differ.sum())} of "
                  f"{differ.size} points differ from the CPU, "
                  f"{int(via_unknown.sum())} of them to or from Unknown",
                  flush=True)
    for m, li, agree in agreements:
        check(agree >= MAP_AGREEMENT,
              f"map {100 + m} layer {li} labels agree with the CPU at "
              f"{agree:.6f} of points (limit {MAP_AGREEMENT})")

    print(result_line(device), flush=True)


if __name__ == "__main__":
    main()

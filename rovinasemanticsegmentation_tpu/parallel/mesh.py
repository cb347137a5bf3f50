"""Device meshes and sharded pipeline steps.

The reference's concurrency inventory maps onto mesh axes (SURVEY.md §2.5):

- ``data``: keyframe batches — replaces the per-frame worker thread
  (``/root/reference/src/segmenter.cpp:323``) and OpenMP-over-trees training
  loop (``third-party/libforest/src/learning.cpp:1046``) with data
  parallelism across devices;
- ``model``: forest trees (inference/training) and CRF point shards — XLA
  inserts psum/all-gather collectives where a sharded tree sum or lattice
  reduction crosses the axis.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P


def make_mesh(n_devices: int, axis_names: Tuple[str, str] = ("data", "model")) -> Mesh:
    """A 2-D mesh over the first ``n_devices`` devices.

    The model axis gets the largest power-of-two factor <= 4 that divides
    ``n_devices`` (trees come in small counts, resources/config.json:39);
    the data axis gets the rest.
    """
    devices = np.array(jax.devices()[:n_devices])
    model = 1
    for cand in (4, 2):
        if n_devices % cand == 0:
            model = cand
            break
    data = n_devices // model
    return Mesh(devices.reshape(data, model), axis_names)


def shard_batch_pipeline(mesh: Mesh) -> None:
    """One sharded batched inference step on tiny shapes (dry-run probe).

    Data-parallel over frames, tree-parallel over the forest: the per-point
    tree-sum crosses the ``model`` axis, so XLA lowers it to an all-reduce.
    """
    from ..models.forest import pack_node_records, random_forest
    from ..pipelines.single_frame import _frame_batch_impl

    data = mesh.shape["data"]
    model = mesh.shape["model"]
    rng = np.random.default_rng(0)
    b = 2 * data
    h, w = 24, 32
    trees = max(4, model)

    rgb = jnp.asarray(rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8))
    depth = jnp.asarray(rng.integers(600, 14000, (b, h, w)).astype(np.uint16))
    kinv = jnp.asarray(
        np.tile(np.linalg.inv([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]]), (b, 1, 1))
    ).astype(jnp.float32)
    rot = jnp.tile(jnp.eye(3, dtype=jnp.float32), (b, 1, 1))
    trans = jnp.zeros((b, 3), dtype=jnp.float32)
    forest = random_forest(
        rng, num_trees=trees, depth=6, num_features=366,
        class_counts=[8, 9], max_nodes=63,
    )

    rec_np, feat_bits = pack_node_records(
        forest.split_feature, forest.left_child, forest.threshold
    )
    static = dict(
        stride=2, patch_size=15, reduce_size=5,
        use_color_patch=True, use_depth=True, use_height=True, use_normal=True,
        max_depth=forest.max_depth, feat_bits=feat_bits,
        descent="xla", interpret=False,
        class_counts=tuple(forest.class_counts),
        fill_value=0.0, out_h=h, out_w=w,
    )

    def step(rgb, depth, kinv, rot, trans, rec, hist):
        return _frame_batch_impl(
            rgb, depth, kinv, rot, trans,
            jnp.float32(0.5), jnp.float32(15.0),
            rec, hist, **static,
        )

    dp = NamedSharding(mesh, P("data"))
    tp = NamedSharding(mesh, P("model"))
    rgb = jax.device_put(rgb, dp)
    depth = jax.device_put(depth, dp)
    kinv = jax.device_put(kinv, dp)
    rot = jax.device_put(rot, dp)
    trans = jax.device_put(trans, dp)
    rec = jax.device_put(jnp.asarray(rec_np), tp)
    hist = jax.device_put(jnp.asarray(forest.leaf_hist), tp)

    out = jax.jit(step)(rgb, depth, kinv, rot, trans, rec, hist)
    jax.block_until_ready(out)
    assert len(out) == b
    posteriors, labels = out[0]
    assert labels[0].shape == (h, w)
    assert posteriors[1].shape == (h, w, 9)

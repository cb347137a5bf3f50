"""Multi-label random forest as structure-of-arrays tensors.

Array re-design of the edited-libforest classifier
(``/root/reference/third-party/libforest/include/libforest/classifiers.h:62-344``,
``/root/reference/third-party/libforest/src/classifier.cpp:57-235``).

The reference stores each tree as parallel vectors ``splitFeatures``,
``thresholds``, ``leftChild`` (right child = left + 1; ``leftChild == 0``
means leaf, classifiers.h:191-206) plus per-leaf single-layer log-histograms
and multi-layer ``multi_histograms[node][layer][class]``. Here those become
dense, tree-padded arrays so a whole batch of points traverses all trees in
one fused XLA computation (or the Pallas descent of ``ops/forest_pallas.py``):

- ``split_feature``  int32  [T, N]
- ``threshold``      float32[T, N]
- ``left_child``     int32  [T, N]
- ``leaf_hist``      float32[T, N, L, C_max]  (class-padded with zeros)

Prediction follows ``DecisionTree::findLeafNode`` (classifier.cpp:97-117):
``node <- left_child[node] + (x[f] >= thr)`` iterated to the tree's maximum
depth (a leaf is a fixed point because padded leaf rows keep ``left_child=0``
and the update is masked), then per-layer leaf log-histograms are gathered
and summed over trees (``RandomForest::multiClassLogPosterior``,
classifier.cpp:187-208).

The binary ``forest.dat`` codec is implemented bit-for-bit
(``io.h:34-108`` writeBinary/readBinary layout, ``classifier.cpp:134-152``
field order, ``classifier.cpp:210-235`` ensemble framing) so models trained
by the C++ tools load directly.
"""

from __future__ import annotations

import io as _io
import struct
from dataclasses import dataclass, field, replace
from functools import partial
from typing import BinaryIO, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class Forest:
    """A random forest in SoA tensor form.

    ``arrays`` live as NumPy on the host; use :func:`device_forest` to place
    them on accelerators (optionally sharded over a mesh axis along T).
    """

    split_feature: np.ndarray  # [T, N] int32
    threshold: np.ndarray  # [T, N] float32
    left_child: np.ndarray  # [T, N] int32
    leaf_hist: np.ndarray  # [T, N, L, C_max] float32
    class_counts: Tuple[int, ...]  # per-layer class counts (<= C_max)
    node_counts: Tuple[int, ...]  # real node count per tree (<= N)
    max_depth: int  # deepest leaf over all trees
    # Single-layer forests are modeled as L=1.
    multi_label: bool = True

    @property
    def num_trees(self) -> int:
        return self.split_feature.shape[0]

    @property
    def num_layers(self) -> int:
        return self.leaf_hist.shape[2]

    @property
    def padded_nodes(self) -> int:
        return self.split_feature.shape[1]

    def tree_view(self, t: int) -> "TreeArrays":
        n = self.node_counts[t]
        return TreeArrays(
            split_feature=self.split_feature[t, :n],
            threshold=self.threshold[t, :n],
            left_child=self.left_child[t, :n],
            leaf_hist=self.leaf_hist[t, :n],
        )


@dataclass
class TreeArrays:
    split_feature: np.ndarray
    threshold: np.ndarray
    left_child: np.ndarray
    leaf_hist: np.ndarray  # [n, L, C_max]


def _tree_max_depth(left_child: np.ndarray) -> int:
    """Depth of the deepest leaf (root = depth 0), iteratively."""
    n = len(left_child)
    if n == 0:
        return 0
    depth = np.zeros(n, dtype=np.int32)
    max_d = 0
    # Nodes are created in order, so children always have larger indices
    # (DecisionTree::splitNode appends, classifiers.h/classifier.cpp:77-95).
    for node in range(n):
        l = left_child[node]
        if l != 0:
            depth[l] = depth[node] + 1
            depth[l + 1] = depth[node] + 1
            max_d = max(max_d, depth[node] + 1)
    return int(max_d)


def build_forest(
    trees: Sequence[TreeArrays],
    class_counts: Sequence[int],
    multi_label: bool = True,
    pad_nodes_to: int = 128,
) -> Forest:
    """Pack per-tree arrays into padded SoA tensors."""
    t_count = len(trees)
    node_counts = tuple(len(t.split_feature) for t in trees)
    n_max = max(node_counts) if node_counts else 1
    n_pad = -(-n_max // pad_nodes_to) * pad_nodes_to
    num_layers = len(class_counts)
    c_max = max(class_counts) if class_counts else 1

    split_feature = np.zeros((t_count, n_pad), dtype=np.int32)
    threshold = np.zeros((t_count, n_pad), dtype=np.float32)
    left_child = np.zeros((t_count, n_pad), dtype=np.int32)
    leaf_hist = np.zeros((t_count, n_pad, num_layers, c_max), dtype=np.float32)
    max_depth = 0
    for t, tree in enumerate(trees):
        n = node_counts[t]
        split_feature[t, :n] = tree.split_feature
        threshold[t, :n] = tree.threshold
        left_child[t, :n] = tree.left_child
        leaf_hist[t, :n] = tree.leaf_hist
        max_depth = max(max_depth, _tree_max_depth(tree.left_child))
    return Forest(
        split_feature=split_feature,
        threshold=threshold,
        left_child=left_child,
        leaf_hist=leaf_hist,
        class_counts=tuple(int(c) for c in class_counts),
        node_counts=node_counts,
        max_depth=max_depth,
        multi_label=multi_label,
    )


# ======================================================================
# Inference
# ======================================================================


def _feature_bits(num_features: int) -> int:
    bits = 1
    while (1 << bits) < num_features:
        bits += 1
    return bits


def pack_node_records(
    split_feature: np.ndarray, left_child: np.ndarray, threshold: np.ndarray
) -> Tuple[np.ndarray, int]:
    """Pack (feat | left << bits, threshold-bits) into one [T, 2N] i32 array.

    Traversal then needs two gathers per level instead of four — the node's
    metadata and threshold sit side by side in one record table, in the
    same cache line.
    """
    t, n = split_feature.shape
    bits = _feature_bits(int(split_feature.max()) + 2)
    if (int(left_child.max()) << bits) >= 2**31:
        raise ValueError("tree too large for packed records")
    meta = split_feature.astype(np.int32) | (left_child.astype(np.int32) << bits)
    rec = np.stack(
        [meta, np.ascontiguousarray(threshold, np.float32).view(np.int32)],
        axis=-1,
    )  # [T, N, 2] — row gathers amortize better than two element gathers
    return rec, bits


@partial(jax.jit, static_argnames=("max_depth", "feat_bits"))
def _find_leaves_packed(
    features: jnp.ndarray,  # [P, D] f32
    records: jnp.ndarray,  # [T, N, 2] i32 packed node records
    max_depth: int,
    feat_bits: int,
) -> jnp.ndarray:  # [P, T] i32 leaf node ids
    """Vectorized findLeafNode (classifier.cpp:97-117) over points x trees.

    Masked descent over packed records with early exit: a leaf has
    ``left_child == 0`` so its node index is a fixed point; the while loop
    stops once every point of every tree sits on a leaf, which for typical
    trained forests is well before the depth cap.
    """
    num_trees = records.shape[0]
    p = features.shape[0]
    mask = (1 << feat_bits) - 1

    def step(state):
        level, node, _ = state
        rows = jax.vmap(lambda r, idx: jnp.take(r, idx, axis=0), in_axes=(0, 1))(
            records, node
        )  # [T, P, 2]
        meta = rows[..., 0].T
        thr = jax.lax.bitcast_convert_type(rows[..., 1].T, jnp.float32)
        f = meta & mask
        lc = meta >> feat_bits
        x = jnp.take_along_axis(features, f, axis=1)  # [P, T]
        nxt = lc + (x >= thr).astype(jnp.int32)  # x < thr -> left
        new_node = jnp.where(lc == 0, node, nxt)
        any_active = jnp.any(lc != 0)
        return level + 1, new_node, any_active

    def cond(state):
        level, _, any_active = state
        return jnp.logical_and(level < max_depth, any_active)

    node = jnp.zeros((p, num_trees), dtype=jnp.int32)
    _, node, _ = jax.lax.while_loop(
        cond, step, (jnp.int32(0), node, jnp.bool_(True))
    )
    return node


@partial(jax.jit, static_argnames=("max_depth",))
def _find_leaves(
    features: jnp.ndarray,  # [P, D] f32
    split_feature: jnp.ndarray,  # [T, N] i32
    threshold: jnp.ndarray,  # [T, N] f32
    left_child: jnp.ndarray,  # [T, N] i32
    max_depth: int,
) -> jnp.ndarray:  # [P, T] i32 leaf node ids
    """Unpacked-table variant of :func:`_find_leaves_packed` (reference/tests)."""

    num_trees = split_feature.shape[0]
    p = features.shape[0]
    node = jnp.zeros((p, num_trees), dtype=jnp.int32)

    def step(node):
        # Gather node attributes: [P, T]
        f = _gather_tree_nodes(split_feature, node)
        thr = _gather_tree_nodes(threshold, node)
        lc = _gather_tree_nodes(left_child, node)
        x = jnp.take_along_axis(features, f, axis=1)  # [P, T]
        go_right = (x >= thr).astype(jnp.int32)  # x < thr -> left
        nxt = lc + go_right
        return jnp.where(lc == 0, node, nxt)

    node = jax.lax.fori_loop(0, max_depth, lambda _, n: step(n), node)
    return node


def _gather_tree_nodes(arr_tn: jnp.ndarray, node_pt: jnp.ndarray) -> jnp.ndarray:
    """arr[T, N][t, node[p, t]] -> [P, T]."""
    # Transpose to [T, P] gather then back; take_along_axis over axis 1.
    taken = jnp.take_along_axis(arr_tn, node_pt.T, axis=1)  # [T, P]
    return taken.T


def _sum_leaf_histograms(
    leaf_hist: jnp.ndarray, leaves: jnp.ndarray
) -> jnp.ndarray:
    """Gather per-tree leaf log-histograms and sum (classifier.cpp:187-208).

    One row gather per tree from its [N, L*C] table.
    """
    num_trees, n, num_layers, c = leaf_hist.shape
    flat = leaf_hist.reshape(num_trees, n, num_layers * c)
    gathered = jax.vmap(lambda h, idx: jnp.take(h, idx, axis=0), in_axes=(0, 1))(
        flat, leaves
    )  # [T, P, L*C]
    return gathered.sum(axis=0).reshape(-1, num_layers, c)


@partial(jax.jit, static_argnames=("max_depth", "feat_bits"))
def forest_log_posterior_packed(
    features: jnp.ndarray,  # [P, D]
    records: jnp.ndarray,  # [T, 2N] packed node records
    leaf_hist: jnp.ndarray,  # [T, N, L, C]
    max_depth: int,
    feat_bits: int,
) -> jnp.ndarray:  # [P, L, C]
    leaves = _find_leaves_packed(features, records, max_depth, feat_bits)
    return _sum_leaf_histograms(leaf_hist, leaves)


@partial(jax.jit, static_argnames=("max_depth",))
def forest_log_posterior(
    features: jnp.ndarray,  # [P, D]
    split_feature: jnp.ndarray,
    threshold: jnp.ndarray,
    left_child: jnp.ndarray,
    leaf_hist: jnp.ndarray,  # [T, N, L, C]
    max_depth: int,
) -> jnp.ndarray:  # [P, L, C]
    """Summed per-layer leaf log-histograms over trees.

    Mirrors ``RandomForest::multiClassLogPosterior`` (classifier.cpp:187-208):
    the ensemble posterior is the elementwise sum of each tree's leaf
    log-histogram.
    """
    leaves = _find_leaves(features, split_feature, threshold, left_child, max_depth)
    return _sum_leaf_histograms(leaf_hist, leaves)


class ForestPredictor:
    """Convenience wrapper holding device arrays and static metadata."""

    def __init__(self, forest: Forest):
        self.forest = forest
        self.split_feature = jnp.asarray(forest.split_feature)
        self.threshold = jnp.asarray(forest.threshold)
        self.left_child = jnp.asarray(forest.left_child)
        self.leaf_hist = jnp.asarray(forest.leaf_hist)
        self.max_depth = int(forest.max_depth)
        rec_np, self.feat_bits = pack_node_records(
            forest.split_feature, forest.left_child, forest.threshold
        )
        self.records = jnp.asarray(rec_np)

    def log_posterior(self, features: jnp.ndarray) -> jnp.ndarray:
        """[P, D] -> [P, L, C_max]; slice per layer by class_counts."""
        return forest_log_posterior_packed(
            features,
            self.records,
            self.leaf_hist,
            max_depth=self.max_depth,
            feat_bits=self.feat_bits,
        )

    def leaves(self, features: jnp.ndarray) -> jnp.ndarray:
        return _find_leaves_packed(
            features, self.records, self.max_depth, self.feat_bits
        )


# ======================================================================
# Reference forest.dat binary codec
# ======================================================================
#
# writeBinary layout (io.h:34-108):
#   scalar T           -> raw little-endian bytes of T
#   vector<T>          -> int32 count, then each element
# DecisionTree::write (classifier.cpp:144-152):
#   splitFeatures (vec<int>), thresholds (vec<float>), leftChild (vec<int>),
#   histograms (vec<vec<float>>), multi_histograms (vec<vec<vec<float>>>)
# RandomForest::write (classifier.cpp:210-220): int32 tree count, then trees.


def _read_i32(f: BinaryIO) -> int:
    return struct.unpack("<i", f.read(4))[0]


def _write_i32(f: BinaryIO, v: int) -> None:
    f.write(struct.pack("<i", v))


def _read_vec(f: BinaryIO, dtype: np.dtype) -> np.ndarray:
    n = _read_i32(f)
    return np.frombuffer(f.read(n * dtype.itemsize), dtype=dtype).copy()


def _write_vec(f: BinaryIO, arr: np.ndarray, dtype: np.dtype) -> None:
    arr = np.asarray(arr, dtype=dtype)
    _write_i32(f, len(arr))
    f.write(arr.tobytes())


def _read_nested2(f: BinaryIO) -> List[np.ndarray]:
    n = _read_i32(f)
    return [_read_vec(f, np.dtype("<f4")) for _ in range(n)]


def _read_nested3(f: BinaryIO) -> List[List[np.ndarray]]:
    n = _read_i32(f)
    return [_read_nested2(f) for _ in range(n)]


@dataclass
class RawTree:
    """A decoded reference tree prior to SoA packing."""

    split_features: np.ndarray
    thresholds: np.ndarray
    left_child: np.ndarray
    histograms: List[np.ndarray]
    multi_histograms: List[List[np.ndarray]]


def read_reference_tree(f: BinaryIO) -> RawTree:
    return RawTree(
        split_features=_read_vec(f, np.dtype("<i4")),
        thresholds=_read_vec(f, np.dtype("<f4")),
        left_child=_read_vec(f, np.dtype("<i4")),
        histograms=_read_nested2(f),
        multi_histograms=_read_nested3(f),
    )


def write_reference_tree(f: BinaryIO, tree: RawTree) -> None:
    _write_vec(f, tree.split_features, np.dtype("<i4"))
    _write_vec(f, tree.thresholds, np.dtype("<f4"))
    _write_vec(f, tree.left_child, np.dtype("<i4"))
    _write_i32(f, len(tree.histograms))
    for h in tree.histograms:
        _write_vec(f, h, np.dtype("<f4"))
    _write_i32(f, len(tree.multi_histograms))
    for layers in tree.multi_histograms:
        _write_i32(f, len(layers))
        for h in layers:
            _write_vec(f, h, np.dtype("<f4"))


def read_reference_forest(f: BinaryIO) -> List[RawTree]:
    count = _read_i32(f)
    return [read_reference_tree(f) for _ in range(count)]


def write_reference_forest(f: BinaryIO, trees: Sequence[RawTree]) -> None:
    _write_i32(f, len(trees))
    for t in trees:
        write_reference_tree(f, t)


def _load_forest_native(
    data: bytes, class_counts: Optional[Sequence[int]]
) -> Optional[Forest]:
    """Single-pass decode via the C++ codec (native/forest_codec.cpp)."""
    from ..native import native_forest_decode

    decoded = native_forest_decode(data)
    if decoded is None:
        return None
    node_counts, split, thr, left, hist_index, hist_vals = decoded
    if len(node_counts) == 0:
        raise ValueError("Empty forest file")
    multi = bool(len(hist_index)) and bool((hist_index[:, 2] >= 0).any())
    if class_counts is None:
        if multi:
            rows = hist_index[hist_index[:, 2] >= 0]
            num_layers = int(rows[:, 2].max()) + 1
            counts = tuple(
                int(rows[rows[:, 2] == l][:, 3].max()) for l in range(num_layers)
            )
        else:
            counts = (int(hist_index[:, 3].max()) if len(hist_index) else 1,)
    else:
        counts = tuple(int(c) for c in class_counts)
    num_layers = len(counts)
    c_max = max(counts)

    trees: List[TreeArrays] = []
    starts = np.concatenate([[0], np.cumsum(node_counts)])
    hists = [
        np.zeros((int(node_counts[t]), num_layers, c_max), np.float32)
        for t in range(len(node_counts))
    ]
    for t, v, l, length, off in hist_index:
        li = 0 if l < 0 else int(l)
        hists[t][v, li, :length] = hist_vals[off : off + length]
    for t in range(len(node_counts)):
        s, e = starts[t], starts[t + 1]
        trees.append(
            TreeArrays(
                split_feature=split[s:e],
                threshold=thr[s:e],
                left_child=left[s:e],
                leaf_hist=hists[t],
            )
        )
    return build_forest(trees, counts, multi_label=multi)


def load_forest(
    path_or_bytes,
    class_counts: Optional[Sequence[int]] = None,
    use_native: bool = True,
) -> Forest:
    """Load a reference ``forest.dat`` into SoA tensors.

    ``class_counts`` may be omitted; it is then inferred from the first
    non-empty leaf histogram of each layer. Decodes through the C++ codec
    when available, else pure Python.
    """
    if isinstance(path_or_bytes, (bytes, bytearray)):
        data = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as fh:
            data = fh.read()
    if use_native:
        forest = _load_forest_native(data, class_counts)
        if forest is not None:
            return forest
    raw = read_reference_forest(_io.BytesIO(data))
    if not raw:
        raise ValueError("Empty forest file")

    multi = any(any(len(l) for l in t.multi_histograms) for t in raw)
    if multi:
        # Infer per-layer class counts from leaf histogram lengths.
        inferred: List[int] = []
        for t in raw:
            for layers in t.multi_histograms:
                if layers:
                    for li, h in enumerate(layers):
                        while len(inferred) <= li:
                            inferred.append(0)
                        inferred[li] = max(inferred[li], len(h))
        counts = tuple(class_counts) if class_counts else tuple(inferred)
    else:
        c = max((len(h) for t in raw for h in t.histograms), default=1)
        counts = tuple(class_counts) if class_counts else (c,)

    num_layers = len(counts)
    c_max = max(counts)
    trees: List[TreeArrays] = []
    for t in raw:
        n = len(t.split_features)
        hist = np.zeros((n, num_layers, c_max), dtype=np.float32)
        if multi:
            for v, layers in enumerate(t.multi_histograms):
                for li, h in enumerate(layers):
                    hist[v, li, : len(h)] = h
        else:
            for v, h in enumerate(t.histograms):
                hist[v, 0, : len(h)] = h
        trees.append(
            TreeArrays(
                split_feature=t.split_features.astype(np.int32),
                threshold=t.thresholds.astype(np.float32),
                left_child=t.left_child.astype(np.int32),
                leaf_hist=hist,
            )
        )
    return build_forest(trees, counts, multi_label=multi)


def save_forest(path: str, forest: Forest) -> None:
    """Write SoA tensors back to the reference ``forest.dat`` format."""
    raws: List[RawTree] = []
    for t in range(forest.num_trees):
        view = forest.tree_view(t)
        n = len(view.split_feature)
        is_leaf = view.left_child == 0
        if forest.multi_label:
            histograms: List[np.ndarray] = [
                np.zeros(0, dtype=np.float32) for _ in range(n)
            ]
            multi: List[List[np.ndarray]] = []
            for v in range(n):
                if is_leaf[v]:
                    multi.append(
                        [
                            view.leaf_hist[v, li, :c].astype(np.float32)
                            for li, c in enumerate(forest.class_counts)
                        ]
                    )
                else:
                    multi.append([])
        else:
            histograms = [
                view.leaf_hist[v, 0, : forest.class_counts[0]].astype(np.float32)
                if is_leaf[v]
                else np.zeros(0, dtype=np.float32)
                for v in range(n)
            ]
            multi = [[] for _ in range(n)]
        raws.append(
            RawTree(
                split_features=view.split_feature,
                thresholds=view.threshold,
                left_child=view.left_child,
                histograms=histograms,
                multi_histograms=multi,
            )
        )
    with open(path, "wb") as f:
        write_reference_forest(f, raws)


# ======================================================================
# Synthetic forests (tests, benchmarks, graft entry)
# ======================================================================


def random_forest(
    rng: np.random.Generator,
    num_trees: int,
    depth: int,
    num_features: int,
    class_counts: Sequence[int],
    max_nodes: Optional[int] = None,
) -> Forest:
    """A random forest for benchmarks and compile checks.

    Splits random leaves until ``max_nodes`` (default: a complete tree of the
    given depth) — use ``max_nodes`` for deep trees, whose trained node
    counts are far below 2^depth.
    """
    trees = []
    c_max = max(class_counts)
    for _ in range(num_trees):
        # Build a random binary tree by splitting random leaves.
        split_feature = [0]
        threshold = [0.0]
        left_child = [0]
        depths = [0]
        leaves = [0]
        target_nodes = max_nodes if max_nodes else 2 ** (depth + 1) - 1
        while len(split_feature) < target_nodes and leaves:
            idx = leaves.pop(rng.integers(len(leaves)))
            if depths[idx] >= depth:
                continue
            left = len(split_feature)
            for _ in range(2):
                split_feature.append(0)
                threshold.append(0.0)
                left_child.append(0)
                depths.append(depths[idx] + 1)
            left_child[idx] = left
            split_feature[idx] = int(rng.integers(num_features))
            threshold[idx] = float(rng.normal())
            leaves.extend([left, left + 1])
        n = len(split_feature)
        hist = rng.normal(size=(n, len(class_counts), c_max)).astype(np.float32)
        hist *= (np.array(left_child) == 0).astype(np.float32)[:, None, None]
        for li, c in enumerate(class_counts):
            hist[:, li, c:] = 0.0
        trees.append(
            TreeArrays(
                split_feature=np.array(split_feature, dtype=np.int32),
                threshold=np.array(threshold, dtype=np.float32),
                left_child=np.array(left_child, dtype=np.int32),
                leaf_hist=hist,
            )
        )
    return build_forest(trees, class_counts)

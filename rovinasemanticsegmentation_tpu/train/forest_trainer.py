"""Random-forest training: breadth-first, sort-based exact split search.

Array re-design of the libforest learners
(``/root/reference/third-party/libforest/src/learning.cpp:363-1113``,
``include/libforest/learning.h:107-456``). The reference grows each tree
depth-first with per-node std::sort over its examples; here every frontier
node at a depth is processed in ONE batched device step: a single
(segment, value) sort over the whole bootstrap sample, segmented cumulative
class counts, and an entropy sweep evaluate every candidate threshold of
every frontier node simultaneously. The split *criterion* is exact
(reference semantics), only the traversal order and RNG differ — the
reference itself is nondeterministic (unseeded std::random_device,
learning.cpp:18).

Preserved semantics:

- bootstrap sampling with replacement, default size = dataset size
  (``autoconf``, learning.cpp:363-368; bootstrapmulti, data.cpp:325-349);
- per node in the multi-label branch a label layer is drawn uniformly and
  the split optimizes that layer's entropy only (learning.cpp:489-493);
- ``numFeatures = ceil(sqrt(D))`` features sampled per node without
  replacement (:367, :543-546);
- unnormalized entropy ``sum_c -h_c log2 h_c + m log2 m`` summed over both
  children (ENTROPY macro :15, initEntropies :279-293, objective :586);
- candidate thresholds between consecutive sorted values, skipped when the
  gap < 1e-6 (:576-583), threshold = midpoint (:591,603);
- stops: node mass < minSplitExamples, purity, depth > maxDepth (:525),
  child mass < minChildSplitExamples (:606);
- leaf histograms refit on the FULL dataset with inverted class frequency
  weights and log smoothing (updateMultiHistograms :963-1012,
  updateHistograms :918-961, getInvertedClassFrequency data.h:345-369);
- trees train independently (the OpenMP-over-trees loop :1031-1113 becomes
  sequential here and shards over a mesh axis in ``parallel/``).
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..models.forest import Forest, TreeArrays, build_forest
from ..utils.config import Config

log = logging.getLogger(__name__)


@dataclass
class TrainerConfig:
    """Knobs of DecisionTreeLearner/RandomForestLearner (learning.h:107-456)."""

    num_trees: int = 4
    max_depth: int = 30
    min_split_examples: int = 50
    min_child_split_examples: int = 1
    num_features: int = 0  # 0 = autoconf ceil(sqrt(D))
    use_bootstrap: bool = True
    num_bootstrap_examples: int = 0  # 0 = autoconf dataset size
    smoothing: float = 1.0
    seed: int = 0
    # learning.h:111,130-132: weight split entropies by inverted class
    # frequency of the bootstrap sample. Single-label only — the reference
    # prints "not supported in the multi class case" (learning.cpp:498) and
    # proceeds unweighted; train.cpp:232 disables it for ROVINA.
    use_class_frequency: bool = False
    # Grow each tree in ONE device dispatch (grow_tree_device: level loop,
    # rng, and node tables all on device) instead of one dispatch + one
    # sync per level. Same algorithm and stop rules; the rng stream
    # differs, so individual trees differ between the two modes while both
    # stay seed-deterministic.
    device_growth: bool = True
    # > 0 switches the device-growth split search from the exact
    # sort-based sweep to the sort-free binned (histogram) sweep with this
    # many dataset-wide quantile bins per feature (build_feature_bins).
    # Candidates restrict to global bin boundaries — statistically
    # equivalent splits (XGBoost-style global sketch; near-exact for the
    # 363/366 integer-valued Lab features); a histogram scatter replaces
    # the per-slot sorts. 0 = exact mode.
    split_bins: int = 0

    @classmethod
    def from_config(cls, conf: Config, seed: int = 0) -> "TrainerConfig":
        """train.cpp:225-239."""
        return cls(
            num_trees=conf.get_int("num_trees"),
            max_depth=conf.get_int("max_depth"),
            min_split_examples=conf.get_int("min_split_sample"),
            seed=seed,
        )


# ======================================================================
# Batched split search (one device step per (depth, feature-slot))
# ======================================================================


def _unnormalized_entropy(counts: jnp.ndarray) -> jnp.ndarray:
    """sum_c -h_c log2 h_c + m log2 m over the last axis (ENTROPY macro)."""
    mass = counts.sum(axis=-1)
    term = jnp.where(counts > 0, -counts * jnp.log2(jnp.maximum(counts, 1e-30)), 0.0)
    mass_term = jnp.where(mass > 0, mass * jnp.log2(jnp.maximum(mass, 1e-30)), 0.0)
    return term.sum(axis=-1) + mass_term


def _unnormalized_entropy_t(counts_t: jnp.ndarray) -> jnp.ndarray:
    """Like :func:`_unnormalized_entropy` over axis 0 ([C, Ns] layout)."""
    mass = counts_t.sum(axis=0)
    term = jnp.where(
        counts_t > 0, -counts_t * jnp.log2(jnp.maximum(counts_t, 1e-30)), 0.0
    )
    mass_term = jnp.where(mass > 0, mass * jnp.log2(jnp.maximum(mass, 1e-30)), 0.0)
    return term.sum(axis=0) + mass_term


@partial(jax.jit, static_argnames=("num_segments", "num_classes"))
def split_search_step(
    vals: jnp.ndarray,  # [Ns] feature value per example (node's slot-k feature)
    seg: jnp.ndarray,  # [Ns] frontier index per example, num_segments = inactive
    cls: jnp.ndarray,  # [Ns] class label per example (node's chosen layer)
    class_weights: jnp.ndarray,  # [C] entropy weights (ones = unweighted)
    num_segments: int,
    num_classes: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Best split per frontier segment for one feature slot.

    Returns (objective [F], threshold [F], left_mass [F], right_mass [F]);
    objective = +inf where no valid split exists.
    """
    ns = vals.shape[0]
    ns_pad = -(-ns // 128) * 128
    sorted_seg, sorted_vals, sorted_cls = jax.lax.sort(
        (seg, vals, cls), num_keys=2
    )
    active = sorted_seg < num_segments

    # Class prefix machinery in [C, Ns] layout, the sorted stream as the
    # minor axis; the stream cumsum is a two-level prefix (cumsums within
    # 128-element rows + a carry of row totals) like the CRF splat.
    onehot_t = (
        (sorted_cls[None, :] == jnp.arange(num_classes)[:, None])
        & active[None, :]
    ).astype(jnp.float32)  # [C, Ns]
    oh_p = jnp.pad(onehot_t, ((0, 0), (0, ns_pad - ns)))
    x2 = oh_p.reshape(num_classes, ns_pad // 128, 128)
    within = jnp.cumsum(x2, axis=2)
    rowtot = within[:, :, -1]
    carry = jnp.cumsum(rowtot, axis=1) - rowtot
    cum_t = (within + carry[:, :, None]).reshape(num_classes, ns_pad)[:, :ns]
    zero = jnp.zeros((num_classes, 1), jnp.float32)
    cum_excl_t = jnp.concatenate([zero, cum_t[:, :-1]], axis=1)

    idx = jnp.arange(ns, dtype=jnp.int32)
    prev_seg = jnp.concatenate([jnp.full((1,), -1, jnp.int32), sorted_seg[:-1]])
    is_start = sorted_seg != prev_seg
    start_idx = jax.lax.cummax(jnp.where(is_start, idx, 0))
    left_t = cum_excl_t - jnp.take(cum_excl_t, start_idx, axis=1)  # [C, Ns]

    # Segment totals WITHOUT a scatter (the stream is already
    # segment-sorted): the inclusive prefix at each
    # segment's LAST element minus at its start. End positions flow
    # backwards with a reversed cummax.
    next_seg = jnp.concatenate([sorted_seg[1:], jnp.full((1,), -2, jnp.int32)])
    is_end = sorted_seg != next_seg
    # Nearest end at-or-after i == i's segment end (reversed cummax).
    end_idx = ns - 1 - jax.lax.cummax(
        jnp.flip(jnp.where(is_end, ns - 1 - idx, 0))
    )[::-1]
    totals_t = jnp.take(cum_t, end_idx, axis=1) - jnp.take(
        cum_excl_t, start_idx, axis=1
    )
    right_t = totals_t - left_t

    prev_vals = jnp.concatenate([sorted_vals[:1], sorted_vals[:-1]])
    left_mass = left_t.sum(axis=0)
    valid = (
        active
        & ~is_start
        & (sorted_vals - prev_vals >= 1e-6)  # learning.cpp:576-583
        & (left_mass > 0)
    )
    # Entropy on class-prior-weighted counts (EfficientEntropyHistogram's
    # weighted_histogram/weighted_mass, learning.cpp:220-256); masses and
    # validity stay UNWEIGHTED (getMass(), :258).
    wl = left_t * class_weights[:, None]
    wr = right_t * class_weights[:, None]
    objective = jnp.where(
        valid,
        _unnormalized_entropy_t(wl) + _unnormalized_entropy_t(wr),
        jnp.inf,
    )
    threshold = 0.5 * (prev_vals + sorted_vals)

    # Per-segment argmin with earliest-position tie-breaking, again
    # scatter-free: a SEGMENTED min-scan (the classic contiguous-segment
    # operator: later element keeps its own value unless the earlier one
    # is in the same segment and not worse), read out at segment ends
    # found by binary search over the sorted segment ids.
    def seg_op(a, b):
        seg_a, obj_a, idx_a = a
        seg_b, obj_b, idx_b = b
        take_a = (seg_a == seg_b) & (obj_a <= obj_b)
        return (
            seg_b,
            jnp.where(take_a, obj_a, obj_b),
            jnp.where(take_a, idx_a, idx_b),
        )

    _, scan_obj, scan_idx = jax.lax.associative_scan(
        seg_op, (sorted_seg, objective, idx)
    )
    seg_ids = jnp.arange(num_segments, dtype=jnp.int32)
    # Last element of each segment id (or 0 if the segment is empty).
    # method="sort": one merge sort instead of the default scan-based
    # binary search's 17 dependent tiny scan steps.
    pos = jnp.searchsorted(
        sorted_seg, seg_ids, side="right", method="sort"
    ).astype(jnp.int32)
    has = pos > jnp.searchsorted(
        sorted_seg, seg_ids, side="left", method="sort"
    ).astype(jnp.int32)
    last = jnp.clip(pos - 1, 0, ns - 1)
    best_obj = jnp.where(has, jnp.take(scan_obj, last), jnp.inf)
    safe_win = jnp.where(
        has & jnp.isfinite(best_obj), jnp.take(scan_idx, last), ns - 1
    )
    best_thr = jnp.take(threshold, safe_win)
    best_left = jnp.take(left_mass, safe_win)
    best_right = jnp.take(right_t.sum(axis=0), safe_win)
    return best_obj, best_thr, best_left, best_right


@partial(jax.jit, static_argnames=("num_segments", "num_classes"))
def multi_slot_split_search(
    x: jnp.ndarray,  # [Ns, D]
    feats: jnp.ndarray,  # [F, K] sampled feature ids per frontier node
    seg: jnp.ndarray,  # [Ns] frontier slot per example (F = inactive)
    seg_search: jnp.ndarray,  # [Ns] like seg but masking unsearchable nodes
    cls: jnp.ndarray,  # [Ns]
    class_weights: jnp.ndarray,  # [C]
    num_segments: int,
    num_classes: int,
):
    """All K feature slots of one level in a single device step.

    The slots ride a ``lax.scan`` (sequential on device, ONE small slot
    body): unrolling K = 20 bodies makes a graph whose compile grows with
    K for every frontier bucket; whether a vmap over slots is faster on
    the GPU is not measured. The per-example values for ALL slots ride one
    batched [Ns, K] take_along_axis up front (a one-hot-matmul alternative
    materializes [Ns, F] per slot, which explodes at wide frontiers).
    """
    seg_c = jnp.minimum(seg, num_segments - 1)
    feat_all = jnp.take(feats, seg_c, axis=0)  # [Ns, K]
    vals_all = jnp.take_along_axis(x, feat_all, axis=1)  # [Ns, K]

    def one_slot(carry, vals):  # vals [Ns]
        return carry, split_search_step(
            vals, seg_search, cls, class_weights, num_segments, num_classes
        )

    _, outs = jax.lax.scan(one_slot, jnp.int32(0), vals_all.T)
    return outs  # each [K, F]


# ======================================================================
# Binned (histogram) split search — the sort-free device-fast mode
# ======================================================================


@partial(jax.jit, static_argnames=("num_bins",))
def build_feature_bins(
    x_full: jnp.ndarray,  # [N, D] f32
    num_bins: int = 256,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One-time per-feature quantile binning for the binned split search.

    Returns ``(xb [N, D] int32 bin indices, boundaries [D, B-1] f32)``.
    Boundaries sit at VALUE-TRANSITION midpoints of the sorted column
    (0.5*(v_i + v_{i+1}) where v_i != v_{i+1}), picked evenly over the
    column's transitions: a feature with <= B-1 distinct-value gaps gets
    EVERY gap as a candidate (the exact sweep's full candidate set —
    this covers the 363/366 integer-valued Lab patch features at B=256),
    while a continuous feature degrades to rank quantiles (every rank is
    a transition — the XGBoost-style global sketch). Rank-positioned
    quantiles alone land inside duplicate runs on integer data and MISS
    distinct-value gaps (measured ~2% held-out accuracy loss).

    The bin index is VALUE-based — ``bin(x) = #(t <= x)`` — so equal
    feature values always share a bin and ``bin(x) <= j <=> x < t[d, j]``
    holds exactly: a split "left = bins <= j" corresponds exactly to the
    float descent rule ``x >= t`` (classifier.cpp:107) with the boundary
    stored as the node threshold. Statistical, not bit, parity with the
    exact mode (held-out accuracy asserted in tests/test_trainer.py).
    """
    n, d = x_full.shape
    b = num_bins
    xs = jax.lax.sort(x_full, dimension=0)  # per-column sort, once
    mid = 0.5 * (xs[:-1, :] + xs[1:, :])  # [n-1, D] candidate midpoints
    is_trans = (xs[1:, :] != xs[:-1, :]).astype(jnp.int32)  # [n-1, D]
    cums = jnp.cumsum(is_trans, axis=0)  # [n-1, D]
    count = cums[-1, :]  # [D] distinct-value gaps per feature

    def col_boundaries(cums_col, mid_col, count_col):
        # k-th boundary = midpoint of transition ordinal
        # floor((k+1)*count/B) + 1 (1-indexed, in 1..count): all
        # transitions when count <= B-1, an even spread otherwise.
        k = jnp.arange(1, b, dtype=jnp.int32)
        target = (k * count_col) // b + 1
        pos = jnp.searchsorted(cums_col, target, side="left")
        t = jnp.take(mid_col, jnp.clip(pos, 0, mid_col.shape[0] - 1))
        return jnp.where(count_col > 0, t, jnp.inf)

    boundaries = jax.vmap(col_boundaries, in_axes=(1, 1, 0))(
        cums, mid, count
    )  # [D, B-1]

    def col_bins(t_col, x_col):
        return jnp.searchsorted(t_col, x_col, side="right").astype(jnp.int32)

    xb = jax.vmap(col_bins, in_axes=(0, 1), out_axes=1)(boundaries, x_full)
    return xb, boundaries


def _binned_slot_search(
    bv: jnp.ndarray,  # [Ns] bin index per example for this slot's feature
    seg: jnp.ndarray,  # [Ns] frontier slot (num_segments = inactive/masked)
    cls: jnp.ndarray,  # [Ns] class label per example (node's chosen layer)
    class_weights: jnp.ndarray,  # [C]
    num_segments: int,
    num_classes: int,
    num_bins: int,
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Best boundary per frontier node for one feature slot — sort-free.

    One scatter-add builds per-(node, class, bin) counts; a cumsum over
    bins gives every candidate's left histogram at once; the weighted
    entropy sweep and per-node argmin mirror :func:`split_search_step`'s
    objective (learning.cpp:563-600) over the boundary candidate set.
    Returns (objective [F], boundary index [F], left/right mass [F]).
    Layout [F, C, B]: bins are the minor axis, which the cumsum runs
    along.
    """
    f, c, b = num_segments, num_classes, num_bins
    active = seg < f
    key = (jnp.minimum(seg, f - 1) * c + cls) * b + jnp.minimum(bv, b - 1)
    key = jnp.where(active, key, f * c * b)
    hist = (
        jnp.zeros((f * c * b,), jnp.float32)
        .at[key]
        .add(1.0, mode="drop")
        .reshape(f, c, b)
    )
    left = jnp.cumsum(hist, axis=2)[:, :, : b - 1]  # [F, C, B-1]
    tot = hist.sum(axis=2)  # [F, C]
    right = tot[:, :, None] - left
    left_mass = left.sum(axis=1)  # [F, B-1]
    right_mass = right.sum(axis=1)
    wl = left * class_weights[None, :, None]
    wr = right * class_weights[None, :, None]

    def ent(h):  # unnormalized entropy over the class axis (axis=1)
        m = h.sum(axis=1)
        term = jnp.where(h > 0, -h * jnp.log2(jnp.maximum(h, 1e-30)), 0.0)
        mt = jnp.where(m > 0, m * jnp.log2(jnp.maximum(m, 1e-30)), 0.0)
        return term.sum(axis=1) + mt

    objective = jnp.where(
        (left_mass > 0) & (right_mass > 0), ent(wl) + ent(wr), jnp.inf
    )  # [F, B-1]
    bidx = jnp.argmin(objective, axis=1).astype(jnp.int32)  # first minimum
    best_obj = jnp.take_along_axis(objective, bidx[:, None], axis=1)[:, 0]
    best_lm = jnp.take_along_axis(left_mass, bidx[:, None], axis=1)[:, 0]
    best_rm = jnp.take_along_axis(right_mass, bidx[:, None], axis=1)[:, 0]
    return best_obj, bidx, best_lm, best_rm


@partial(
    jax.jit, static_argnames=("num_segments", "num_classes", "num_bins")
)
def multi_slot_split_search_binned(
    xb: jnp.ndarray,  # [Ns, D] int32 bin indices
    boundaries: jnp.ndarray,  # [D, B-1] f32
    feats: jnp.ndarray,  # [F, K]
    seg: jnp.ndarray,  # [Ns]
    seg_search: jnp.ndarray,  # [Ns] masked
    cls: jnp.ndarray,  # [Ns]
    class_weights: jnp.ndarray,  # [C]
    num_segments: int,
    num_classes: int,
    num_bins: int,
):
    """All K feature slots of one level, binned: the exact-mode scan's
    three ~Ns-element sorts per slot (main sort + 2x searchsorted
    method="sort") become one scatter + histogram sweep per slot.
    Returns (objective [K, F], threshold [K, F], left/right mass [K, F])
    with thresholds resolved from the boundary table."""
    seg_c = jnp.minimum(seg, num_segments - 1)
    feat_all = jnp.take(feats, seg_c, axis=0)  # [Ns, K]
    bins_all = jnp.take_along_axis(xb, feat_all, axis=1)  # [Ns, K]

    def one_slot(carry, bv):
        return carry, _binned_slot_search(
            bv, seg_search, cls, class_weights,
            num_segments, num_classes, num_bins,
        )

    _, (obj, bidx, lm, rm) = jax.lax.scan(
        one_slot, jnp.int32(0), bins_all.T
    )
    # Threshold per (slot, node) from the global boundary table.
    thr = boundaries[feats.T, bidx]  # [K, F]
    return obj, thr, lm, rm


@partial(jax.jit, static_argnames=("num_segments", "num_classes", "num_layers"))
def node_stats_scatter(
    seg: jnp.ndarray,  # [Ns]
    labels: jnp.ndarray,  # [Ns, L]
    num_segments: int,
    num_classes: int,
    num_layers: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mass [F], distinct-class count per layer [F, L]) via one
    scatter-add — the binned mode's sort-free :func:`node_stats_step`."""
    f, c, l = num_segments, num_classes, num_layers
    active = seg < f
    keys = (
        jnp.minimum(seg, f - 1)[:, None] * l + jnp.arange(l)[None, :]
    ) * c + labels  # [Ns, L]
    keys = jnp.where(active[:, None], keys, f * l * c)
    counts = (
        jnp.zeros((f * l * c,), jnp.float32)
        .at[keys.reshape(-1)]
        .add(1.0, mode="drop")
        .reshape(f, l, c)
    )
    mass = counts[:, 0, :].sum(axis=1)
    distinct = (counts > 0).sum(axis=2)  # [F, L]
    return mass, distinct


def _level_core(
    x: jnp.ndarray,  # [Ns, D]
    labels: jnp.ndarray,  # [Ns, L]
    node_of: jnp.ndarray,  # [Ns] tree-node id per example
    base: jnp.ndarray,  # scalar i32: id of the FIRST frontier node
    table_len: jnp.ndarray,  # scalar i32: tree-table length (children alloc here)
    feats: jnp.ndarray,  # [F, K] sampled feature ids per frontier slot
    layers: jnp.ndarray,  # [F] chosen layer per slot
    depth_ok: jnp.ndarray,  # scalar bool (breadth-first: uniform per level)
    min_split: jnp.ndarray,  # scalar
    min_child: jnp.ndarray,  # scalar
    class_weights: jnp.ndarray,  # [C]
    num_segments: int,
    num_classes: int,
    num_layers: int,
    xb: Optional[jnp.ndarray] = None,  # [Ns, D] bin indices (binned mode)
    boundaries: Optional[jnp.ndarray] = None,  # [D, B-1] (binned mode)
    num_bins: int = 0,  # 0 = exact sort-based search
):
    """The ENTIRE level as one traceable block: slot mapping, node stats,
    stop checks (learning.cpp:521-531), the K-slot split search, best-slot
    selection, child-id allocation, and the example partition.

    Profiling showed the ~15 small per-level host<->device transfers cost
    ~5 s/level through the dev link (each carries ~0.1-0.3 s of latency)
    while the actual search executes in ~0.3 s. Breadth-first node
    numbering makes everything device-derivable: the frontier occupies
    consecutive ids [base, base + F), so the slot of an example is
    ``node_of - base``, and a host-parity child allocation is
    ``table_len + 2 * exclusive_cumsum(splitting)`` (the host applies
    splits in ascending slot order). Returns (splitting [F], best_feat [F],
    best_thr [F], new node_of). Called per level by the host-driven
    :func:`fused_level_step` and in-loop by :func:`grow_tree_device`.
    """
    # Slot per example; ids below base are settled leaves from earlier
    # levels, anything outside [0, F) parks at the inactive slot F.
    seg_raw = node_of - base
    seg = jnp.where(
        (seg_raw >= 0) & (seg_raw < num_segments), seg_raw, num_segments
    )
    seg_c = jnp.minimum(seg, num_segments - 1)

    # Per-example class from the slot's chosen layer (learning.cpp:489-493).
    layer_of = jnp.take(layers, seg_c)
    cls = jnp.take_along_axis(labels, layer_of[:, None], axis=1)[:, 0]
    cls = jnp.where(seg < num_segments, cls, 0)

    stats = node_stats_scatter if num_bins > 0 else node_stats_step
    mass, distinct = stats(
        seg, labels, num_segments, num_classes, num_layers
    )
    layer_distinct = jnp.take_along_axis(distinct, layers[:, None], axis=1)[
        :, 0
    ]
    searchable = (mass >= min_split) & (layer_distinct > 1) & depth_ok  # [F]
    seg_search = jnp.where(
        jnp.take(searchable, seg_c) & (seg < num_segments),
        seg,
        num_segments,
    )
    if num_bins > 0:
        obj_k, thr_k, lm_k, rm_k = multi_slot_split_search_binned(
            xb, boundaries, feats, seg, seg_search, cls, class_weights,
            num_segments, num_classes, num_bins,
        )
    else:
        obj_k, thr_k, lm_k, rm_k = multi_slot_split_search(
            x, feats, seg, seg_search, cls, class_weights, num_segments,
            num_classes,
        )

    # Best slot per frontier node; argmin keeps the FIRST minimum, exactly
    # the host sweep's strict-< update order (learning.cpp:588).
    best_slot = jnp.argmin(obj_k, axis=0)  # [F]
    best_obj = jnp.take_along_axis(obj_k, best_slot[None], axis=0)[0]
    best_thr = jnp.take_along_axis(thr_k, best_slot[None], axis=0)[0]
    best_lm = jnp.take_along_axis(lm_k, best_slot[None], axis=0)[0]
    best_rm = jnp.take_along_axis(rm_k, best_slot[None], axis=0)[0]
    best_feat = jnp.take_along_axis(feats, best_slot[:, None], axis=1)[:, 0]

    splitting = (
        searchable
        & jnp.isfinite(best_obj)
        & (best_lm >= min_child)
        & (best_rm >= min_child)  # learning.cpp:606
    )
    sp_i = splitting.astype(jnp.int32)
    left_ids = table_len + 2 * (jnp.cumsum(sp_i) - sp_i)  # host alloc order

    # Partition (the reference's per-node example redistribution).
    sp_e = jnp.take(splitting, seg_c) & (seg < num_segments)
    f_e = jnp.take(best_feat, seg_c)
    thr_e = jnp.take(best_thr, seg_c)
    left_e = jnp.take(left_ids, seg_c)
    xv = jnp.take_along_axis(x, f_e[:, None], axis=1)[:, 0]
    node_new = jnp.where(
        sp_e, left_e + (xv >= thr_e).astype(jnp.int32), node_of
    )
    return splitting, best_feat, best_thr, node_new


@partial(
    jax.jit,
    static_argnames=("num_segments", "num_classes", "num_layers"),
)
def fused_level_step(
    x, labels, node_of, base, table_len, feats, layers, depth_ok,
    min_split, min_child, class_weights,
    num_segments: int, num_classes: int, num_layers: int,
):
    """One level as one dispatch (see :func:`_level_core`); returns
    (packed [3, F]: splitting/feature/threshold — the level's ONLY
    download — and the new node_of, which STAYS on device)."""
    splitting, best_feat, best_thr, node_new = _level_core(
        x, labels, node_of, base, table_len, feats, layers, depth_ok,
        min_split, min_child, class_weights,
        num_segments, num_classes, num_layers,
    )
    packed = jnp.stack(
        [
            splitting.astype(jnp.float32),
            best_feat.astype(jnp.float32),
            best_thr,
        ]
    )  # [3, F]
    return packed, node_new


@partial(
    jax.jit,
    static_argnames=(
        "f_pad", "cap", "max_depth", "k", "num_classes", "num_layers",
        "num_bins",
    ),
)
def grow_tree_device(
    x: jnp.ndarray,  # [Ns, D]
    labels: jnp.ndarray,  # [Ns, L] int32
    seed: jnp.ndarray,  # scalar uint32: device rng stream for this tree
    min_split: jnp.ndarray,
    min_child: jnp.ndarray,
    class_weights: jnp.ndarray,  # [C]
    f_pad: int,  # frontier capacity (static)
    cap: int,  # node-table capacity (static)
    max_depth: int,
    k: int,  # features sampled per node
    num_classes: int,
    num_layers: int,
    xb: Optional[jnp.ndarray] = None,  # [Ns, D] bin indices (binned mode)
    boundaries: Optional[jnp.ndarray] = None,  # [D, B-1] (binned mode)
    num_bins: int = 0,  # 0 = exact sort-based split search
):
    """Grow the WHOLE tree in ONE dispatch: a ``while_loop`` over levels
    around :func:`_level_core`, with per-level rng (layer choice +
    k-of-D feature subsets) drawn ON DEVICE and the node tables
    (split_feature/threshold/left_child/depth) maintained on device.

    The host-driven level loop costs one sync + one dispatch per level —
    ~0.2-0.3 s each through a high-latency host link, ~10-15 s of pure
    latency for a 25-level tree (the C++ reference's whole 8-thread train
    is 12.8 s, learning.cpp:1046). Here the host uploads the bootstrap
    sample and downloads the finished tables: two round trips per tree.

    RNG: per level, ``fold_in(key, depth)``; layers ~ randint, feature
    subsets = top-k of per-slot uniforms (a uniformly random k-subset,
    exactly DecisionTreeLearner's sampling-without-replacement semantics,
    learning.cpp:543-546, in a fixed-shape formulation). The stream
    differs from the host path's numpy draws, so host- and device-grown
    trees differ individually while matching statistically; both are
    seed-deterministic.

    Returns (split_feature [cap], threshold [cap], left_child [cap],
    node_depth [cap], table_len, f_count, depth). ``f_count > f_pad`` or
    ``table_len + 2 * f_count > cap`` on exit means the static buckets
    overflowed and the caller must retry with bigger buckets. Growth is
    deterministic for a given (seed, f_pad): reruns reproduce the same
    tree, but a retry at a BIGGER f_pad draws different per-slot uniforms
    (the rng draw shapes include f_pad) and so grows a different — equally
    valid — tree; the retry loop re-checks its own overflow. (A small
    nonzero ``f_count`` with neither bound exceeded is a NORMAL exit: the
    depth limit hit with leaves still pending; their records are already
    zeroed leaves.)
    """
    ns, d = x.shape
    key = jax.random.PRNGKey(seed)

    def cond(state):
        _, _, _, _, _, nn, _, f_count, depth = state
        # depth > max_depth needs no pass: depth_ok would block every
        # split, and the pending frontier's records are already zeroed
        # leaves from their allocation.
        return (
            (f_count > 0)
            & (f_count <= f_pad)
            & (nn + 2 * f_count <= cap)
            & (depth <= max_depth)
        )

    def body(state):
        node_of, sf, th, lc, dep, nn, base, f_count, depth = state
        k_lay, k_feat = jax.random.split(jax.random.fold_in(key, depth))
        layers = jax.random.randint(
            k_lay, (f_pad,), 0, num_layers, dtype=jnp.int32
        )
        # k-of-d without replacement per slot: indices of the k largest
        # uniforms (a uniformly random subset in random order).
        pri = jax.random.uniform(k_feat, (f_pad, d))
        _, feats = jax.lax.top_k(pri, k)  # [f_pad, k] i32
        splitting, best_feat, best_thr, node_of = _level_core(
            x, labels, node_of, base, nn,
            feats.astype(jnp.int32), layers, depth <= max_depth,
            min_split, min_child, class_weights,
            f_pad, num_classes, num_layers,
            xb=xb, boundaries=boundaries, num_bins=num_bins,
        )
        sp_i = splitting.astype(jnp.int32)
        splits = jnp.sum(sp_i)
        left_ids = nn + 2 * (jnp.cumsum(sp_i) - sp_i)
        # Write the splitting slots' records (non-splitting slots keep the
        # zeroed leaf records their allocation created).
        ids = base + jnp.arange(f_pad, dtype=jnp.int32)
        ids_w = jnp.where(splitting, ids, cap)
        sf = sf.at[ids_w].set(best_feat, mode="drop")
        th = th.at[ids_w].set(best_thr, mode="drop")
        lc = lc.at[ids_w].set(left_ids, mode="drop")
        # Children [nn, nn + 2*splits) are depth+1.
        cids = nn + jnp.arange(2 * f_pad, dtype=jnp.int32)
        cids = jnp.where(jnp.arange(2 * f_pad) < 2 * splits, cids, cap)
        dep = dep.at[cids].set(depth + 1, mode="drop")
        return (
            node_of, sf, th, lc, dep,
            nn + 2 * splits, nn, 2 * splits, depth + 1,
        )

    state = (
        jnp.zeros((ns,), jnp.int32),  # node_of
        jnp.zeros((cap,), jnp.int32),  # split_feature
        jnp.zeros((cap,), jnp.float32),  # threshold
        jnp.zeros((cap,), jnp.int32),  # left_child
        jnp.zeros((cap,), jnp.int32),  # node depth
        jnp.int32(1),  # table_len (root exists)
        jnp.int32(0),  # base
        jnp.int32(1),  # f_count
        jnp.int32(0),  # depth
    )
    state = jax.lax.while_loop(cond, body, state)
    _, sf, th, lc, dep, nn, _, f_count, depth = state
    return sf, th, lc, dep, nn, f_count, depth


@partial(
    jax.jit,
    static_argnames=(
        "f_pad", "cap", "max_depth", "k", "num_classes", "num_layers",
        "num_bins",
    ),
)
def grow_forest_device(
    x_full: jnp.ndarray,  # [N, D] full dataset (device-resident)
    labels_full: jnp.ndarray,  # [N, L] int32
    idx: jnp.ndarray,  # [T, Ns] bootstrap indices per tree
    seeds: jnp.ndarray,  # [T] uint32 device rng streams
    min_split: jnp.ndarray,
    min_child: jnp.ndarray,
    class_weights: jnp.ndarray,  # [T, C] per-tree entropy weights
    f_pad: int,
    cap: int,
    max_depth: int,
    k: int,
    num_classes: int,
    num_layers: int,
    xb_full: Optional[jnp.ndarray] = None,  # [N, D] bin indices (binned)
    boundaries: Optional[jnp.ndarray] = None,  # [D, B-1] (binned)
    num_bins: int = 0,  # binned split search (bins shared by all trees)
):
    """ALL trees' growth in ONE dispatch — the single-chip analogue of the
    reference's OpenMP-over-trees loop (learning.cpp:1031-1113).

    ``vmap`` over :func:`grow_tree_device`: per-tree bootstrap gathers run
    inside the dispatch, the level ``while_loop`` becomes one loop of
    ``max_t levels_t`` iterations carrying every tree's (batched) level
    work, instead of ``sum_t levels_t`` sequential levels across T
    dispatches — and the per-tree host syncs disappear. Per-tree streams
    are BIT-IDENTICAL to :func:`grow_tree_device` run tree-by-tree at the
    same (seed, f_pad): the rng depends only on those, so the fused and
    sequential paths grow the same trees (asserted in
    tests/test_trainer.py). In binned mode the full-dataset bin table is
    shared by every tree (and both paths), preserving that bit-identity.
    """

    def one_tree(idx_t, seed_t, cw_t):
        return grow_tree_device(
            jnp.take(x_full, idx_t, axis=0),
            jnp.take(labels_full, idx_t, axis=0),
            seed_t, min_split, min_child, cw_t,
            f_pad=f_pad, cap=cap, max_depth=max_depth, k=k,
            num_classes=num_classes, num_layers=num_layers,
            xb=(None if num_bins == 0 else jnp.take(xb_full, idx_t, axis=0)),
            boundaries=boundaries, num_bins=num_bins,
        )

    return jax.vmap(one_tree)(idx, seeds, class_weights)


@partial(jax.jit, static_argnames=("num_nodes", "num_classes", "max_depth"))
def forest_refit_device(
    x: jnp.ndarray,  # [N, D] FULL dataset
    labels: jnp.ndarray,  # [N, L] int32
    freqs: jnp.ndarray,  # [L, C]
    split_feature: jnp.ndarray,  # [T, num_nodes]
    threshold: jnp.ndarray,  # [T, num_nodes]
    left_child: jnp.ndarray,  # [T, num_nodes]
    num_nodes: int,
    num_classes: int,
    max_depth: int,
) -> jnp.ndarray:  # [T, num_nodes, L, C]
    """Every tree's full-dataset leaf refit in ONE dispatch (vmapped
    :func:`_leaf_histograms_all`; same per-tree numbers)."""
    return jax.vmap(
        lambda sf, th, lc: _leaf_histograms_all(
            x, labels, freqs, sf, th, lc,
            num_nodes=num_nodes, num_classes=num_classes,
            max_depth=max_depth,
        )
    )(split_feature, threshold, left_child)


@partial(jax.jit, static_argnames=("num_segments", "num_classes", "num_layers"))
def node_stats_step(
    seg: jnp.ndarray,  # [Ns]
    labels: jnp.ndarray,  # [Ns, L]
    num_segments: int,
    num_classes: int,
    num_layers: int,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """(mass [F], distinct-class count per layer [F, L]) for stop checks.

    Scatter-free: a segment sort plus the same two-level cumsum as
    :func:`split_search_step` makes the per-slot class counts pure prefix
    differences read out at segment boundaries, instead of a
    ``counts.at[seg].add(onehot)`` scatter.
    """
    ns = seg.shape[0]
    ns_pad = -(-ns // 128) * 128
    sorted_all = jax.lax.sort(
        (seg,) + tuple(labels[:, l] for l in range(num_layers)), num_keys=1
    )
    sorted_seg = sorted_all[0]
    active = sorted_seg < num_segments

    # [L*C, Ns] one-hot, the sorted stream as the minor axis.
    onehot_t = jnp.concatenate(
        [
            (
                (sorted_all[1 + l][None, :] == jnp.arange(num_classes)[:, None])
                & active[None, :]
            ).astype(jnp.float32)
            for l in range(num_layers)
        ],
        axis=0,
    )  # [L*C, Ns]
    lc = num_layers * num_classes
    oh_p = jnp.pad(onehot_t, ((0, 0), (0, ns_pad - ns)))
    x2 = oh_p.reshape(lc, ns_pad // 128, 128)
    within = jnp.cumsum(x2, axis=2)
    rowtot = within[:, :, -1]
    carry = jnp.cumsum(rowtot, axis=1) - rowtot
    cum_t = (within + carry[:, :, None]).reshape(lc, ns_pad)[:, :ns]

    seg_ids = jnp.arange(num_segments, dtype=jnp.int32)
    lo = jnp.searchsorted(
        sorted_seg, seg_ids, side="left", method="sort"
    ).astype(jnp.int32)
    hi = jnp.searchsorted(
        sorted_seg, seg_ids, side="right", method="sort"
    ).astype(jnp.int32)
    has = hi > lo
    at_hi = jnp.take(cum_t, jnp.clip(hi - 1, 0, ns - 1), axis=1)
    at_lo = jnp.where(
        (lo > 0)[None, :], jnp.take(cum_t, jnp.clip(lo - 1, 0, ns - 1), axis=1), 0.0
    )
    counts = jnp.where(has[None, :], at_hi - at_lo, 0.0)  # [L*C, F]
    counts = counts.reshape(num_layers, num_classes, num_segments)
    mass = (hi - lo).astype(jnp.float32)
    distinct = (counts > 0).sum(axis=1).T  # [F, L]
    return mass, distinct


# ======================================================================
# Tree growth (host-driven levels, device-batched steps)
# ======================================================================


class _DeviceTreeResult:
    """Builder-compatible view over device-grown node tables."""

    def __init__(self, sf, th, lc, dep, nn: int):
        self.split_feature = np.asarray(sf[:nn], np.int32)
        self.threshold = np.asarray(th[:nn], np.float32)
        self.left_child = np.asarray(lc[:nn], np.int32)
        self.depth = np.asarray(dep[:nn], np.int32)


def _grow_tree_on_device(
    x: jnp.ndarray,  # [Ns, D] device-resident bootstrap sample
    y: np.ndarray,  # [Ns, L]
    cfg: "TrainerConfig",
    rng: np.random.Generator,
    num_classes: int,
    xb: Optional[jnp.ndarray] = None,  # [Ns, D] bin idx (split_bins > 0)
    boundaries: Optional[jnp.ndarray] = None,  # [D, B-1]
) -> _DeviceTreeResult:
    """Drive :func:`grow_tree_device`: two host<->device round trips per
    tree in the common case (upload sample implicit, download tables),
    retrying with 4x buckets on the rare frontier/table overflow (the
    retry grows a fresh seed-deterministic tree at the new bucket —
    see :func:`grow_tree_device` on why the prefix is not preserved)."""
    ns, d = x.shape
    num_layers = y.shape[1]
    k = cfg.num_features or int(math.ceil(math.sqrt(d)))
    y_dev = jnp.asarray(y.astype(np.int32))
    class_weights = _tree_class_weights(cfg, y, ns, num_classes)
    seed = np.uint32(rng.integers(0, 2**32, dtype=np.uint64))

    # Bucket sizing: every level's splitting nodes hold >= min_split
    # examples and partition <= ns of them, so the frontier never exceeds
    # 2 * ns / min_split; total nodes <= 2 * leaves <= 4 * ns / min_child
    # is loose, so cap starts at a pow2 estimate and grows on overflow.
    # (Shared with the fused-forest path: the rng streams depend on f_pad.)
    f_pad, cap = _forest_buckets(ns, cfg)

    while True:
        sf, th, lc, dep, nn, f_count, _ = grow_tree_device(
            x, y_dev, jnp.uint32(seed),
            jnp.float32(cfg.min_split_examples),
            jnp.float32(cfg.min_child_split_examples),
            jnp.asarray(class_weights),
            f_pad=f_pad, cap=cap, max_depth=cfg.max_depth, k=k,
            num_classes=num_classes, num_layers=num_layers,
            xb=xb, boundaries=boundaries, num_bins=cfg.split_bins,
        )
        nn_i = int(nn)
        fc = int(f_count)
        if fc > f_pad:
            f_pad *= 4
            continue
        if nn_i + 2 * fc > cap:
            cap *= 4
            continue
        return _DeviceTreeResult(sf, th, lc, dep, nn_i)


def _forest_buckets(ns: int, cfg: "TrainerConfig") -> Tuple[int, int]:
    """(f_pad, cap) static buckets for device growth — ONE formula shared
    by the per-tree and fused-forest paths so their rng streams (which
    depend on f_pad) stay bit-identical."""

    def pow2(v):
        return 1 << max(0, int(v - 1).bit_length())

    depth_cap = 1 << min(cfg.max_depth + 1, 24)
    f_pad = min(
        pow2(2 * ns // max(cfg.min_split_examples, 1) + 1),
        pow2(ns),
        depth_cap,
    )
    f_pad = max(64, f_pad)
    cap = max(256, min(pow2(2 * ns), pow2(4 * (2 ** min(cfg.max_depth, 26)))))
    cap = min(cap, pow2(16 * ns))
    return f_pad, cap


def _grow_forest_fused(
    x_full: jnp.ndarray,  # [N, D]
    labels: np.ndarray,  # [N, L] host
    labels_dev: jnp.ndarray,  # [N, L] int32 device
    freqs_dev: jnp.ndarray,  # [L, c_max]
    cfg: "TrainerConfig",
    num_classes: int,
    tree_ids: Sequence[int],  # global tree indices (seed streams)
    n_bootstrap: int,
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
    """All trees in two dispatches (growth + refit); returns per-tree
    (split_feature, threshold, left_child, depth, raw_hist [nn, L, C]).

    Host side: per-tree bootstrap index/seed draws (the same rng order as
    the per-tree path: idx, then seed), one small [T] sync per growth
    dispatch for the overflow check (exactly one dispatch unless a tree
    overflows its bucket — then only the overflowing trees regrow at the
    escalated bucket, keeping fused==per-tree bit-identity), a device-side
    table slice to the pow2 of the LARGEST tree, and one download per
    table.
    """
    n, d = x_full.shape
    num_layers = labels.shape[1]
    # No bootstrap = the full dataset per tree (the per-tree path's
    # semantics), regardless of num_bootstrap_examples.
    ns = n_bootstrap if cfg.use_bootstrap else n
    k = cfg.num_features or int(math.ceil(math.sqrt(d)))

    idx_np = np.zeros((len(tree_ids), ns), np.int32)
    seeds_np = np.zeros(len(tree_ids), np.uint32)
    cw_np = np.zeros((len(tree_ids), num_classes), np.float32)
    for i, t in enumerate(tree_ids):
        rng = np.random.default_rng((cfg.seed, t))
        if cfg.use_bootstrap:
            idx_np[i] = rng.integers(0, n, size=ns)
        else:
            idx_np[i] = np.arange(n)
        cw_np[i] = _tree_class_weights(cfg, labels[idx_np[i]], ns, num_classes)
        seeds_np[i] = np.uint32(rng.integers(0, 2**32, dtype=np.uint64))

    f_pad0, cap0 = _forest_buckets(ns, cfg)
    idx_dev = jnp.asarray(idx_np)
    seeds_dev = jnp.asarray(seeds_np)
    cw_dev = jnp.asarray(cw_np)
    xb_full = bnd = None
    if cfg.split_bins > 0:
        xb_full, bnd = build_feature_bins(x_full, num_bins=cfg.split_bins)

    # Per-tree bucket escalation, bit-identical to the per-tree path
    # (_grow_tree_on_device): the rng streams depend on f_pad, so an
    # overflow may regrow ONLY the overflowing trees at the bigger bucket
    # — regrowing everything would silently change every non-overflowing
    # tree and break the documented fused==per-tree equality (round-4
    # advisor, medium). Escalation order matches the per-tree loop
    # exactly: frontier overflow first (f_pad x4, recheck), then table
    # overflow (cap x4). Trees sharing a bucket pair ride one dispatch,
    # so the common case stays growth+refit = two dispatches total.
    buckets = {i: (f_pad0, cap0) for i in range(len(tree_ids))}
    grown: dict = {}  # i -> (sf_i, th_i, lc_i, dep_i, nn_i) device rows
    pending = list(range(len(tree_ids)))
    while pending:
        groups: dict = {}
        for i in pending:
            groups.setdefault(buckets[i], []).append(i)
        pending = []
        for (f_pad, cap), idxs in groups.items():
            sel = jnp.asarray(np.array(idxs, np.int32))
            sf, th, lc, dep, nn, fc, _ = grow_forest_device(
                x_full, labels_dev, idx_dev[sel], seeds_dev[sel],
                jnp.float32(cfg.min_split_examples),
                jnp.float32(cfg.min_child_split_examples),
                cw_dev[sel],
                f_pad=f_pad, cap=cap, max_depth=cfg.max_depth, k=k,
                num_classes=num_classes, num_layers=num_layers,
                xb_full=xb_full, boundaries=bnd, num_bins=cfg.split_bins,
            )
            nn_np = np.asarray(nn)  # one host sync per dispatch ([T']+[T'])
            fc_np = np.asarray(fc)
            for j, i in enumerate(idxs):
                if fc_np[j] > f_pad:
                    buckets[i] = (f_pad * 4, cap)
                    pending.append(i)
                elif nn_np[j] + 2 * fc_np[j] > cap:
                    buckets[i] = (f_pad, cap * 4)
                    pending.append(i)
                else:
                    grown[i] = (sf[j], th[j], lc[j], dep[j], int(nn_np[j]))

    # Refit once for every tree at the pow2 bucket of the largest tree;
    # rows past a tree's own nn are untouched zeros (sliced off below).
    nn_b = max(
        256, 1 << int(max(g[4] for g in grown.values()) - 1).bit_length()
    )
    md_b = -(-max(cfg.max_depth, 1) // 8) * 8

    def _row(a, fill):
        return (a[:nn_b] if a.shape[0] >= nn_b
                else jnp.pad(a, (0, nn_b - a.shape[0]), constant_values=fill))

    sf_s = jnp.stack([_row(grown[i][0], 0) for i in range(len(tree_ids))])
    th_s = jnp.stack([_row(grown[i][1], 0) for i in range(len(tree_ids))])
    lc_s = jnp.stack([_row(grown[i][2], 0) for i in range(len(tree_ids))])
    dep_s = jnp.stack([_row(grown[i][3], 0) for i in range(len(tree_ids))])
    raw_all = np.asarray(
        forest_refit_device(
            x_full, labels_dev, freqs_dev, sf_s, th_s, lc_s,
            num_nodes=nn_b, num_classes=num_classes, max_depth=md_b,
        )
    )
    sf_np = np.asarray(sf_s)
    th_np = np.asarray(th_s)
    lc_np = np.asarray(lc_s)
    dep_np = np.asarray(dep_s)
    out = []
    for i in range(len(tree_ids)):
        m = grown[i][4]
        out.append(
            (sf_np[i, :m], th_np[i, :m], lc_np[i, :m], dep_np[i, :m],
             raw_all[i, :m])
        )
    return out


class _TreeBuilder:
    def __init__(self) -> None:
        self.split_feature: List[int] = [0]
        self.threshold: List[float] = [0.0]
        self.left_child: List[int] = [0]
        self.depth: List[int] = [0]

    def split(self, node: int, feature: int, threshold: float) -> int:
        left = len(self.split_feature)
        for _ in range(2):
            self.split_feature.append(0)
            self.threshold.append(0.0)
            self.left_child.append(0)
            self.depth.append(self.depth[node] + 1)
        self.split_feature[node] = int(feature)
        self.threshold[node] = float(threshold)
        self.left_child[node] = left
        return left


def _tree_class_weights(
    cfg: "TrainerConfig", y: np.ndarray, ns: int, num_classes: int
) -> np.ndarray:
    """Per-tree class weights (inverted frequency when enabled).

    libforest parity: weighting is unsupported in the multi-label case —
    learning.cpp:498 prints "not supported" and proceeds with ones.
    """
    num_layers = y.shape[1]
    weights = np.ones(num_classes, np.float32)
    if cfg.use_class_frequency:
        if num_layers > 1:
            log.warning(
                "class frequency weighting is not supported in the "
                "multi-label case (libforest parity); proceeding unweighted"
            )
        else:
            counts = np.bincount(
                y[:, 0].astype(np.int64), minlength=num_classes
            ).astype(np.float32)
            weights = np.where(counts > 0, ns / np.maximum(counts, 1), 1.0)
    return weights.astype(np.float32)


def _grow_tree(
    x: jnp.ndarray,  # [Ns, D] bootstrap sample (device)
    y: np.ndarray,  # [Ns, L] labels (host + device)
    cfg: TrainerConfig,
    rng: np.random.Generator,
    num_classes: int,
) -> _TreeBuilder:
    ns, d = x.shape
    num_layers = y.shape[1]
    k = cfg.num_features or int(math.ceil(math.sqrt(d)))
    y_dev = jnp.asarray(y.astype(np.int32))

    # Inverted class frequency of the bootstrap sample (learning.cpp:710,
    # data.h:346-357).
    class_weights_dev = jnp.asarray(_tree_class_weights(cfg, y, ns, num_classes))

    tree = _TreeBuilder()
    node_of = jnp.zeros((ns,), jnp.int32)
    # Breadth-first growth keeps each level's frontier on CONSECUTIVE node
    # ids, so the device derives slots from node_of and a base id alone —
    # the whole level runs as ONE dispatch + ONE small download
    # (fused_level_step; the former ~15 small transfers per level cost
    # ~5 s each through the dev link).
    base = 0
    f_count = 1
    depth = 0

    while f_count > 0:
        # Bucket the frontier-slot count to a power of 4: the jitted level
        # step is specialized on num_segments, and without bucketing every
        # level of every tree forces a fresh compile (minutes each through
        # a remote-compile backend). Padded slots have no member examples.
        f_pad = 1 << (((f_count - 1).bit_length() + 1) // 2 * 2)  # power of 4

        # Random layer per frontier node (learning.cpp:489-493) and
        # feature sampling without replacement (:543-546); the rng stream
        # draws exactly f_count values, independent of bucketing.
        layers = rng.integers(0, num_layers, size=f_count).astype(np.int32)
        layers_pad = np.concatenate(
            [layers, np.zeros(f_pad - f_count, np.int32)]
        )
        feats = np.stack(
            [rng.permutation(d)[:k] for _ in range(f_count)]
        ).astype(np.int32)  # [F, k]
        feats_pad = np.concatenate(
            [feats, np.zeros((f_pad - f_count, k), np.int32)]
        )

        nn = len(tree.split_feature)
        packed, node_of = fused_level_step(
            x, y_dev, node_of,
            jnp.int32(base), jnp.int32(nn),
            jnp.asarray(feats_pad), jnp.asarray(layers_pad),
            jnp.asarray(depth <= cfg.max_depth),
            jnp.float32(cfg.min_split_examples),
            jnp.float32(cfg.min_child_split_examples),
            class_weights_dev,
            f_pad, num_classes, num_layers,
        )
        arr = np.asarray(packed)  # the level's one host sync
        splitting = arr[0, :f_count] > 0
        best_feat = arr[1, :f_count].astype(np.int32)
        best_thr = arr[2, :f_count]

        # Host bookkeeping mirrors the device's child allocation exactly
        # (ascending slot order, two ids per split from the table end).
        splits = 0
        for s in range(f_count):
            if not splitting[s]:
                continue
            left = tree.split(base + s, int(best_feat[s]), float(best_thr[s]))
            assert left == nn + 2 * splits  # device/host alloc parity
            splits += 1

        base = nn
        f_count = 2 * splits
        depth += 1

    return tree


# ======================================================================
# Leaf histogram refit (updateMultiHistograms, learning.cpp:963-1012)
# ======================================================================


@partial(jax.jit, static_argnames=("num_nodes", "num_classes", "max_depth"))
def _leaf_histograms_all(
    x: jnp.ndarray,  # [N, D] FULL dataset
    labels: jnp.ndarray,  # [N, L] int32, all layers
    freqs: jnp.ndarray,  # [L, C] inverted class frequency per layer
    split_feature: jnp.ndarray,  # [num_nodes] (bucketed)
    threshold: jnp.ndarray,
    left_child: jnp.ndarray,
    num_nodes: int,  # pow2-bucketed: per-tree node counts must not
    num_classes: int,  # force a fresh compile (remote compiles are slow)
    max_depth: int,  # bucketed likewise
) -> jnp.ndarray:  # [num_nodes, L, C] weighted counts
    """All layers' leaf refit in ONE dispatch with ONE shared descent.

    (An earlier per-layer variant re-descended the full dataset once per
    layer and recompiled per tree — num_nodes/max_depth are static and
    differ tree to tree; here the descent runs once and the statics
    arrive pre-bucketed by the caller.)
    """
    node = jnp.zeros((x.shape[0],), jnp.int32)

    def step(node):
        f = jnp.take(split_feature, node)
        thr = jnp.take(threshold, node)
        lc = jnp.take(left_child, node)
        xv = jnp.take_along_axis(x, f[:, None], axis=1)[:, 0]
        nxt = lc + (xv >= thr).astype(jnp.int32)
        return jnp.where(lc == 0, node, nxt)

    node = jax.lax.fori_loop(0, max_depth, lambda _, n: step(n), node)
    outs = []
    for l in range(labels.shape[1]):
        w = jnp.take(freqs[l], labels[:, l])
        onehot = (
            jax.nn.one_hot(labels[:, l], num_classes, dtype=jnp.float32)
            * w[:, None]
        )
        hist = jnp.zeros((num_nodes, num_classes), jnp.float32)
        outs.append(hist.at[node].add(onehot))
    return jnp.stack(outs, axis=1)  # [num_nodes, L, C]


def _inverted_class_frequency(labels: np.ndarray, c: int) -> np.ndarray:
    """data.h:345-369: size / per-class count."""
    counts = np.bincount(labels, minlength=c).astype(np.float64)
    return np.where(counts > 0, len(labels) / np.maximum(counts, 1), 0.0).astype(
        np.float32
    )


def _smooth_histograms(
    raw_all: np.ndarray,  # [nn, L, c_max] weighted counts
    left_child: np.ndarray,  # [nn]
    class_counts: Sequence[int],
    smoothing: float,
) -> np.ndarray:
    """Log smoothing per layer (updateMultiHistograms, learning.cpp:997);
    inner nodes zeroed (no histograms)."""
    nn, num_layers, c_max = raw_all.shape
    hist = np.zeros((nn, num_layers, c_max), np.float32)
    for l in range(num_layers):
        c = class_counts[l]
        raw = raw_all[:, l, :c]
        total = raw.sum(axis=1, keepdims=True)
        hist[:, l, :c] = np.log((raw + smoothing) / (total + c * smoothing))
    hist *= (left_child == 0)[:, None, None]
    return hist


# ======================================================================
# Public API
# ======================================================================


class ForestTrainer:
    """RandomForestLearner equivalent over dense feature/label tensors."""

    def __init__(self, config: TrainerConfig):
        self.config = config

    def learn(
        self,
        features: np.ndarray,  # [N, D] float32
        labels: np.ndarray,  # [N, L] int (all >= 0)
        class_counts: Optional[Sequence[int]] = None,
        multi_label: Optional[bool] = None,
        progress: bool = True,
        checkpoint_path: Optional[str] = None,
        _tree_offset: int = 0,
    ) -> Forest:
        """Train the forest; with ``checkpoint_path``, save after each tree
        and resume from a partial checkpoint (capability the reference
        lacks — its only artifact is the final forest.dat,
        learning.cpp:1031-1113)."""
        features = np.ascontiguousarray(features, dtype=np.float32)
        labels = np.ascontiguousarray(labels)
        if labels.ndim == 1:
            labels = labels[:, None]
        n, d = features.shape
        num_layers = labels.shape[1]
        if multi_label is None:
            multi_label = num_layers > 1
        if class_counts is None:
            class_counts = [int(labels[:, l].max()) + 1 for l in range(num_layers)]
        c_max = max(class_counts)
        cfg = self.config
        n_bootstrap = cfg.num_bootstrap_examples or n

        # Resume from a per-tree checkpoint when present.
        start_tree = 0
        trees: List[TreeArrays] = []
        if checkpoint_path is not None:
            import os

            if os.path.exists(checkpoint_path):
                from ..utils.checkpoint import TrainingCheckpoint

                ckpt, partial = TrainingCheckpoint.load(checkpoint_path)
                if partial is not None and ckpt.completed_trees > 0:
                    start_tree = min(ckpt.completed_trees, cfg.num_trees)
                    trees = [partial.tree_view(t) for t in range(start_tree)]
                    if progress:
                        log.info(
                            "Resuming training at tree %d/%d",
                            start_tree + 1, cfg.num_trees,
                        )

        x_full = jnp.asarray(features)
        # Refit inputs shared by every tree: labels on device and padded
        # [L, c_max] inverted class frequencies.
        labels_dev = jnp.asarray(labels.astype(np.int32))
        freqs_np = np.zeros((num_layers, c_max), np.float32)
        for l in range(num_layers):
            freqs_np[l, : class_counts[l]] = _inverted_class_frequency(
                labels[:, l].astype(np.int64), class_counts[l]
            )
        freqs_dev = jnp.asarray(freqs_np)

        # Fused-forest path: every tree grown in ONE dispatch + refit in
        # one more (grow_forest_device) — the single-chip OpenMP-over-
        # trees analogue. Per-tree checkpointing needs the tree loop, so
        # checkpoint_path keeps the per-tree path.
        if cfg.device_growth and checkpoint_path is None and start_tree < cfg.num_trees:
            t0 = time.perf_counter()
            results = _grow_forest_fused(
                x_full, labels, labels_dev, freqs_dev, cfg, c_max,
                [t + _tree_offset for t in range(start_tree, cfg.num_trees)],
                n_bootstrap,
            )
            for i, (sf_t, th_t, lc_t, dep_t, raw_t) in enumerate(results):
                trees.append(
                    TreeArrays(
                        split_feature=sf_t,
                        threshold=th_t,
                        left_child=lc_t,
                        leaf_hist=_smooth_histograms(
                            raw_t, lc_t, class_counts, cfg.smoothing
                        ),
                    )
                )
                if progress:
                    log.info(
                        "Finished tree %d/%d: %d nodes, depth %d "
                        "(fused forest, %.1fs total)",
                        start_tree + i + 1, cfg.num_trees, len(sf_t),
                        int(dep_t.max()) if len(dep_t) else 0,
                        time.perf_counter() - t0,
                    )
            return build_forest(trees, class_counts, multi_label=multi_label)

        # Shared bin table for the binned device mode (one build per call;
        # per-tree/fused bit-identity needs identical full-dataset bins).
        bins_full = bnd = None
        if cfg.split_bins > 0 and cfg.device_growth:
            bins_full, bnd = build_feature_bins(
                x_full, num_bins=cfg.split_bins
            )

        for t in range(start_tree, cfg.num_trees):
            start = time.perf_counter()
            # Deterministic per-tree stream: resume-safe and shardable
            # (tree-parallel training passes a global tree offset).
            rng = np.random.default_rng((cfg.seed, t + _tree_offset))
            if cfg.use_bootstrap:
                idx = rng.integers(0, n, size=n_bootstrap)
                idx_dev = jnp.asarray(idx)
                xb = jnp.take(x_full, idx_dev, axis=0)
                yb = labels[idx]
                bins_boot = (
                    None if bins_full is None
                    else jnp.take(bins_full, idx_dev, axis=0)
                )
            else:
                xb, yb, bins_boot = x_full, labels, bins_full
            if cfg.device_growth:
                builder = _grow_tree_on_device(
                    xb, yb, cfg, rng, c_max, xb=bins_boot, boundaries=bnd
                )
            else:
                builder = _grow_tree(xb, yb, cfg, rng, c_max)

            # Leaf refit on the full dataset, all layers in one dispatch
            # (:963-1012). Statics are BUCKETED (pow2 nodes, depth to a
            # multiple of 8): per-tree node counts must not each compile a
            # fresh executable (remote compiles cost ~30 s+ apiece; the
            # padding rows are unreachable leaves, sliced off below).
            nn = len(builder.split_feature)
            max_depth = max(builder.depth) if nn else 0
            nn_b = max(256, 1 << int(nn - 1).bit_length())
            md_b = -(-max(max_depth, 1) // 8) * 8
            sf_np = np.zeros(nn_b, np.int32)
            th_np = np.zeros(nn_b, np.float32)
            lc_np = np.zeros(nn_b, np.int32)
            sf_np[:nn] = builder.split_feature
            th_np[:nn] = builder.threshold
            lc_np[:nn] = builder.left_child
            raw_all = np.asarray(
                _leaf_histograms_all(
                    x_full, labels_dev, freqs_dev,
                    jnp.asarray(sf_np), jnp.asarray(th_np), jnp.asarray(lc_np),
                    num_nodes=nn_b, num_classes=c_max, max_depth=md_b,
                )
            )[:nn]
            hist = _smooth_histograms(
                raw_all, np.asarray(builder.left_child), class_counts,
                cfg.smoothing,
            )

            trees.append(
                TreeArrays(
                    split_feature=np.asarray(builder.split_feature, np.int32),
                    threshold=np.asarray(builder.threshold, np.float32),
                    left_child=np.asarray(builder.left_child, np.int32),
                    leaf_hist=hist,
                )
            )
            if progress:
                log.info(
                    "Finished tree %d/%d: %d nodes, depth %d, %.1fs",
                    t + 1, cfg.num_trees, nn, max_depth,
                    time.perf_counter() - start,
                )
            if checkpoint_path is not None:
                from ..utils.checkpoint import TrainingCheckpoint

                partial_forest = build_forest(
                    trees, class_counts, multi_label=multi_label
                )
                TrainingCheckpoint(
                    completed_trees=t + 1,
                    seed=cfg.seed,
                    config=dict(cfg.__dict__),
                ).save(checkpoint_path, partial_forest)

        return build_forest(trees, class_counts, multi_label=multi_label)

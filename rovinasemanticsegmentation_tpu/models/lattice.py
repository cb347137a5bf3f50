"""Permutohedral lattice: O(N*(d+1)) approximate high-dim Gaussian filtering.

Re-design of the reference lattice
(``third-party/densecrf/src/permutohedral.cpp:323-527``) as
static-shape array code. The build (embed, round to the nearest 0-colored remainder point, rank,
barycentric weights, vertex dedup, blur-neighbor table) runs once per local
map as vectorized host NumPy — the hash table becomes ``np.unique`` over
integer key rows. The per-iteration hot path (splat -> d+1 separable blur
passes -> slice) is jitted JAX with static shapes, so mean-field iterations
stay entirely on device.

Semantics preserved exactly:

- elevation with ``scale[i] = inv_std_dev / sqrt((i+1)(i+2))``,
  ``inv_std_dev = sqrt(2/3)*(d+1)`` (permutohedral.cpp:352-356);
- nearest-remainder rounding and rank computation with the reference's
  tie-breaking (:358-415);
- barycentric coordinates with the wrap-around term (:417-426);
- blur stencil ``new = old + 0.5*(n1 + n2)`` along each of the d+1 axes, with
  a zero slot for missing neighbors (:476-508);
- the magic ``alpha = 1/(1+2^-d)`` scale applied at slice time (:509-521);
- ``reverse`` ordering for transpose filtering (:495).

Vertex numbering differs from the reference's insertion-order hash table
(here: lexicographic); filtering results are invariant to numbering.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class PermutohedralLattice:
    """Host-built lattice structure for N points in d dimensions."""

    offsets: np.ndarray  # [N, d+1] int32 vertex index per simplex corner
    barycentric: np.ndarray  # [N, d+1] float32
    blur_n1: np.ndarray  # [d+1, M] int32 neighbor index, M = missing
    blur_n2: np.ndarray  # [d+1, M] int32
    num_vertices: int  # M
    dim: int  # d
    # Simplex geometry kept for the differentiable-barycentric path
    # (lattice_filter_differentiable); None when built by the native builder.
    rem0: "np.ndarray | None" = None  # [N, d+1] float32
    rank: "np.ndarray | None" = None  # [N, d+1] int32
    # Sorted splat stream for the transposed ([C, N]) filter
    # (attach_sorted_stream): contribution (point, weight) pairs sorted by
    # vertex id + per-vertex [start, end) row ranges into that stream.
    sorted_points: "np.ndarray | None" = None  # [Spad] int32
    sorted_weights: "np.ndarray | None" = None  # [Spad] float32
    seg_starts: "np.ndarray | None" = None  # [M] int32
    seg_ends: "np.ndarray | None" = None  # [M] int32

    @property
    def alpha(self) -> float:
        return 1.0 / (1.0 + 2.0 ** (-self.dim))


def build_lattice(
    features: np.ndarray, use_native: bool = True
) -> PermutohedralLattice:
    """Build the lattice for features [N, d] (permutohedral.cpp:323-474).

    Tries the C++ hash-table builder (``native/lattice_builder.cpp``) first;
    falls back to the vectorized NumPy sort/unique path below.
    """
    features = np.asarray(features, dtype=np.float32)
    n, d = features.shape

    if use_native:
        from ..native import native_lattice_build

        built = native_lattice_build(features)
        if built is not None:
            offsets, bary, blur_n1, blur_n2, m = built
            return PermutohedralLattice(
                offsets=offsets,
                barycentric=bary,
                blur_n1=blur_n1,
                blur_n2=blur_n2,
                num_vertices=m,
                dim=d,
            )

    inv_std_dev = np.sqrt(2.0 / 3.0) * (d + 1)
    scale = (1.0 / np.sqrt((np.arange(d) + 2.0) * (np.arange(d) + 1.0))) * inv_std_dev

    # Elevation y = E p: elevated[j] = sum_{k>=j} c_k - j*c_{j-1}, c = f*scale.
    c = features * scale[None, :]  # [N, d]
    suffix = np.concatenate(
        [np.cumsum(c[:, ::-1], axis=1)[:, ::-1], np.zeros((n, 1), np.float32)], axis=1
    )  # suffix[:, j] = sum_{k>=j} c_k, suffix[:, d] = 0
    elevated = np.empty((n, d + 1), dtype=np.float32)
    elevated[:, 0] = suffix[:, 0]
    js = np.arange(1, d + 1)
    elevated[:, 1:] = suffix[:, 1:] - js[None, :] * c

    # Round to the nearest multiple of (d+1) (permutohedral.cpp:372-390).
    down_factor = 1.0 / (d + 1)
    v = down_factor * elevated
    up = np.ceil(v) * (d + 1)
    down = np.floor(v) * (d + 1)
    rem0 = np.where(up - elevated < elevated - down, up, down).astype(np.float32)
    rem_sum = (rem0.sum(axis=1) * down_factor).astype(np.int32)  # [N]

    # Rank: descending order of (elevated - rem0), ties by original index
    # (the reference's pairwise strict-< loop, :392-402).
    di = elevated - rem0
    order = np.argsort(-di, axis=1, kind="stable")
    rank = np.empty((n, d + 1), dtype=np.int32)
    np.put_along_axis(rank, order, np.broadcast_to(np.arange(d + 1), (n, d + 1)), axis=1)

    # Wrap ranks/remainders so the point lies on the plane (:404-415).
    rank = rank + rem_sum[:, None]
    low = rank < 0
    rank = np.where(low, rank + (d + 1), rank)
    rem0 = np.where(low, rem0 + (d + 1), rem0)
    high = rank > d
    rank = np.where(high, rank - (d + 1), rank)
    rem0 = np.where(high, rem0 - (d + 1), rem0)

    # Barycentric coordinates (:417-426).
    bary = np.zeros((n, d + 2), dtype=np.float32)
    vbar = (elevated - rem0) * down_factor
    rows = np.repeat(np.arange(n), d + 1)
    idx = (d - rank).reshape(-1)
    np.add.at(bary, (rows, idx), vbar.reshape(-1))
    np.add.at(bary, (rows, idx + 1), -vbar.reshape(-1))
    bary[:, 0] += 1.0 + bary[:, d + 1]
    barycentric = bary[:, : d + 1]

    # Vertex keys per remainder (:428-435): canonical simplex coordinates.
    canonical = np.empty((d + 1, d + 1), dtype=np.int32)
    for r in range(d + 1):
        canonical[r, : d + 1 - r] = r
        canonical[r, d + 1 - r :] = r - (d + 1)
    # key[:, :d] = rem0[:, :d] + canonical[r, rank[:, :d]]
    keys = (
        rem0[:, None, :d].astype(np.int32)
        + canonical[np.arange(d + 1)[None, :, None], rank[:, None, :d]]
    )  # [N, d+1, d]
    keys_flat = keys.reshape(n * (d + 1), d)

    unique_keys, inverse = np.unique(keys_flat, axis=0, return_inverse=True)
    m = len(unique_keys)
    offsets = inverse.reshape(n, d + 1).astype(np.int32)

    # Blur neighbors (:446-471): for axis j, n1 = key - 1 except +d at j.
    def lookup(query: np.ndarray) -> np.ndarray:
        """Rows of query -> vertex index or M (missing)."""
        # unique_keys is lex-sorted; binary search on a structured view.
        uview = np.ascontiguousarray(unique_keys).view(
            [("", unique_keys.dtype)] * d
        ).ravel()
        qview = np.ascontiguousarray(query).view([("", query.dtype)] * d).ravel()
        pos = np.searchsorted(uview, qview)
        pos_c = np.clip(pos, 0, m - 1)
        found = uview[pos_c] == qview
        return np.where(found, pos_c, m).astype(np.int32)

    blur_n1 = np.empty((d + 1, m), dtype=np.int32)
    blur_n2 = np.empty((d + 1, m), dtype=np.int32)
    for j in range(d + 1):
        n1 = unique_keys - 1
        n2 = unique_keys + 1
        if j < d:
            n1[:, j] = unique_keys[:, j] + d
            n2[:, j] = unique_keys[:, j] - d
        # j == d: the implicit last coordinate changes; the first d coords are
        # all -1 / +1, exactly what n1/n2 already hold.
        blur_n1[j] = lookup(n1)
        blur_n2[j] = lookup(n2)

    return PermutohedralLattice(
        offsets=offsets,
        barycentric=barycentric.astype(np.float32),
        blur_n1=blur_n1,
        blur_n2=blur_n2,
        num_vertices=m,
        dim=d,
        rem0=rem0.astype(np.float32),
        rank=rank.astype(np.int32),
    )


@partial(jax.jit, static_argnames=("num_vertices", "reverse"))
def lattice_filter(
    values: jnp.ndarray,  # [N, C]
    offsets: jnp.ndarray,  # [N, d+1]
    barycentric: jnp.ndarray,  # [N, d+1]
    blur_n1: jnp.ndarray,  # [d+1, M]
    blur_n2: jnp.ndarray,  # [d+1, M]
    num_vertices: int,
    reverse: bool = False,
) -> jnp.ndarray:
    """splat -> blur -> slice (permutohedral.cpp:476-527)."""
    n, c = values.shape
    d1 = offsets.shape[1]  # d+1
    m = num_vertices
    alpha = 1.0 / (1.0 + 2.0 ** (-(d1 - 1)))

    # Splat: scatter-add barycentric-weighted values into vertices. Slot m is
    # the zero slot for missing blur neighbors (the reference's index 0).
    contrib = (values[:, None, :] * barycentric[:, :, None]).reshape(n * d1, c)
    verts = jnp.zeros((m + 1, c), values.dtype)
    verts = verts.at[offsets.reshape(-1)].add(contrib)

    # Blur: d+1 sequential passes, double-buffered in the reference; here the
    # functional update is equivalent. Missing neighbors read the zero slot.
    axes = range(d1 - 1, -1, -1) if reverse else range(d1)
    for j in axes:
        n1v = jnp.take(verts, blur_n1[j], axis=0)
        n2v = jnp.take(verts, blur_n2[j], axis=0)
        real = verts[:m] + 0.5 * (n1v + n2v)
        verts = jnp.concatenate([real, jnp.zeros((1, c), values.dtype)], axis=0)

    # Slice.
    gathered = jnp.take(verts, offsets, axis=0)  # [N, d+1, C]
    out = (gathered * barycentric[:, :, None]).sum(axis=1) * alpha
    return out


@partial(jax.jit, static_argnames=("m_bucket",))
def build_lattice_device(
    features: jnp.ndarray,  # [N, d] float32, device-resident
    m_bucket: int = 1 << 14,
):
    """The WHOLE lattice build on device, shaped for :func:`lattice_filter_t`.

    The host build + upload costs host CPU time plus ~4.4 MB of per-map
    host->device transfer (offsets/barycentric/blur/sorted stream). This
    build needs only the [N, d] features on device: embedding /
    rounding / rank / barycentric are vectorized ports of the host code;
    the hash-table dedup becomes a 3-key lexicographic sort of packed
    16-bit key halves + run detection; blur neighbors resolve by binary
    search over the (ascending) unique keys. All shapes are static:
    vertices pad to ``m_bucket`` with empty splat segments and
    missing-slot blur neighbors, exactly the ``pad_lattice`` contract
    (the zero slot is index ``m_bucket``).

    Returns ``(sorted_points, sorted_weights, seg_starts, seg_ends,
    offsets_t, barycentric_t, blur_n1, blur_n2, m)`` — ``m`` is the real
    vertex count (device scalar); callers must check ``m <= m_bucket``
    and rebuild with a larger bucket on overflow.
    """
    n, d = features.shape
    d1 = d + 1
    s = n * d1
    spad = -(-s // 128) * 128

    keys, bary = _embed_simplex(features)

    kflat = keys.reshape(s, d)  # signed coords, |coord| << 2^15
    packs = _pack_keys16(kflat, d)

    (
        sorted_points,
        sorted_weights,
        seg_starts,
        seg_ends,
        offsets_t,
        m,
        uq,
        ucoord,
    ) = _dedup_sorted(packs, kflat, bary, n, d, m_bucket, spad)
    barycentric_t = bary.T
    blur_n1, blur_n2 = _blur_neighbors_sort(uq, ucoord, m, m_bucket, d)

    return (
        sorted_points,
        sorted_weights,
        seg_starts,
        seg_ends,
        offsets_t,
        barycentric_t,
        blur_n1,
        blur_n2,
        m,
    )


def _embed_simplex(features: jnp.ndarray):
    """Embed, round, rank, barycentric — the pure vector phase of the
    device lattice build (permutohedral.cpp:352-426 semantics). Returns
    ``(keys [N, d+1, d] int32 simplex-corner coords, bary [N, d+1])``."""
    n, d = features.shape
    d1 = d + 1

    inv_std_dev = np.sqrt(2.0 / 3.0) * d1
    scale = jnp.asarray(
        (1.0 / np.sqrt((np.arange(d) + 2.0) * (np.arange(d) + 1.0)))
        * inv_std_dev,
        jnp.float32,
    )
    c = features * scale[None, :]
    suffix = jnp.concatenate(
        [jnp.cumsum(c[:, ::-1], axis=1)[:, ::-1], jnp.zeros((n, 1), jnp.float32)],
        axis=1,
    )
    js = jnp.arange(1, d + 1, dtype=jnp.float32)
    elevated = jnp.concatenate(
        [suffix[:, :1], suffix[:, 1:] - js[None, :] * c], axis=1
    )  # [N, d+1]

    down = 1.0 / d1
    v = down * elevated
    up_ = jnp.ceil(v) * d1
    dn_ = jnp.floor(v) * d1
    rem0 = jnp.where(up_ - elevated < elevated - dn_, up_, dn_)
    rem_sum = (jnp.sum(rem0, axis=1) * down).astype(jnp.int32)  # [N]

    # Descending stable rank of the residuals (ties by index).
    diff = elevated - rem0  # [N, d+1]
    # rank[i] = #{j > i : d_i < d_j} + #{j < i : d_j >= d_i}
    i_idx = jnp.arange(d1)
    later = i_idx[None, :] > i_idx[:, None]  # [i, j] j > i
    cond = jnp.where(
        later[None], diff[:, :, None] < diff[:, None, :],
        diff[:, None, :] >= diff[:, :, None],
    )
    cond = cond & (i_idx[None, :] != i_idx[:, None])[None]
    rank = jnp.sum(cond, axis=2).astype(jnp.int32)  # [N, d+1]

    rank = rank + rem_sum[:, None]
    low = rank < 0
    rank = jnp.where(low, rank + d1, rank)
    rem0 = jnp.where(low, rem0 + d1, rem0)
    high = rank > d
    rank = jnp.where(high, rank - d1, rank)
    rem0 = jnp.where(high, rem0 - d1, rem0)

    # Barycentric — scatter-free: slots take only d+2 values, so the
    # per-row scatter-adds become d+2 masked sums (these were
    # 2 x N*(d+1)-row scatters).
    vbar = (elevated - rem0) * down
    slots = d - rank  # [N, d+1] in [0, d]
    cols = []
    for k in range(d + 2):
        plus = jnp.sum(jnp.where(slots == k, vbar, 0.0), axis=1)
        minus = jnp.sum(jnp.where(slots == k - 1, vbar, 0.0), axis=1)
        cols.append(plus - minus)
    bary = jnp.stack(cols, axis=1)  # [N, d+2]
    bary = bary.at[:, 0].add(1.0 + bary[:, d + 1])
    bary = bary[:, :d1]  # [N, d+1]

    # Simplex corner keys: coordinate i steps by r, wrapping past d - r.
    r_idx = jnp.arange(d1)[None, :, None]  # corner r
    step = jnp.where(rank[:, None, :d] <= d - r_idx, r_idx, r_idx - d1)
    keys = rem0[:, None, :d].astype(jnp.int32) + step  # [N, d+1, d]
    return keys, bary


def _pack_pair16(hi, lo):
    """Two signed 16-bit-range ints -> one int32 preserving lexicographic
    order. Signed packing (hi * 2^16 + unsigned lo); the unsigned
    (hi << 16 | lo) form would flip order once hi >= 2^15."""
    return (hi << 16) + lo + (1 << 15)


def _pack_keys16(kflat: jnp.ndarray, d: int):
    """Pack 16-bit halves -> ceil(d/2) int32 sort keys (list)."""
    nk = (d + 1) // 2
    packs = []
    for i in range(nk):
        hi = kflat[:, 2 * i]
        lo = (
            kflat[:, 2 * i + 1] if 2 * i + 1 < d else jnp.zeros_like(hi) - (1 << 15)
        )
        packs.append(_pack_pair16(hi, lo))
    return packs


def _dedup_sorted(packs, kflat, bary, n, d, m_bucket, spad):
    """Sort-based vertex dedup + sorted splat stream + point offsets.

    Returns ``(sorted_points, sorted_weights, seg_starts, seg_ends,
    offsets_t, m, uq, ucoord)`` where ``uq``/``ucoord`` are the per-vertex
    packed keys / raw coords needed by blur-neighbor resolution."""
    d1 = d + 1
    s = n * d1
    nk = len(packs)
    pos = jnp.arange(s, dtype=jnp.int32)
    sorted_all = jax.lax.sort(tuple(packs) + (pos,), num_keys=nk)
    sp = sorted_all[:nk]
    pos_sorted = sorted_all[nk]

    prev_eq = jnp.ones(s, bool)
    for p in sp:
        prev_eq = prev_eq & (p == jnp.concatenate([p[:1] - 1, p[:-1]]))
    is_new = ~prev_eq
    is_new = is_new.at[0].set(True)
    vid_sorted = jnp.cumsum(is_new.astype(jnp.int32)) - 1  # [S]
    m = vid_sorted[-1] + 1

    # offsets back in point order; clamp overflowed ids into the bucket so
    # downstream indexing stays in range (the caller rejects the build via
    # m anyway). The inverse permutation rides a key sort, not a scatter.
    vid_c = jnp.minimum(vid_sorted, m_bucket - 1)
    offsets_flat = jax.lax.sort((pos_sorted, vid_c), num_keys=1)[1]
    offsets_t = offsets_flat.reshape(n, d1).T  # [d+1, N]

    # Sorted splat stream (pad rows contribute zero weight to vertex m-1's
    # tail only if segments pointed there — they don't: pads sit past S).
    sorted_points = jnp.pad(pos_sorted // d1, (0, spad - s))
    sorted_weights = jnp.pad(
        jnp.take(bary.reshape(-1), pos_sorted), (0, spad - s)
    )
    idx_s = jnp.arange(s, dtype=jnp.int32)
    seg_starts = jnp.zeros(m_bucket, jnp.int32).at[
        jnp.where(is_new, vid_c, m_bucket - 1)
    ].max(jnp.where(is_new, idx_s, 0), mode="drop")
    # Empty padded segments: start == end == 0 would wrongly sum row 0 for
    # vertex ids that exist... they must satisfy start == end. Ends:
    nxt_new = jnp.concatenate([is_new[1:], jnp.ones(1, bool)])
    seg_ends = jnp.zeros(m_bucket, jnp.int32).at[
        jnp.where(nxt_new, vid_c, m_bucket - 1)
    ].max(jnp.where(nxt_new, idx_s + 1, 0), mode="drop")

    # Unique keys/coords per vertex: gathers at the segment starts (each
    # real vertex's start row holds its key), +inf sentinel past m so a
    # padded slot can never win the neighbor merge below. These were nine
    # more S-row scatters. The raw coords come from UNPACKING the packed
    # key words instead of a second [S, d] row-gather of kflat: the pack
    # (hi << 16) + lo + 2^15 is exactly invertible (hi = w >> 16 arithmetic,
    # lo = (w & 0xFFFF) - 2^15) since lo + 2^15 lives in [0, 2^16).
    big = jnp.int32(0x7FFFFFFF)
    real = jnp.arange(m_bucket) < m  # padded vertices -> missing slot
    uq = [jnp.where(real, jnp.take(p, seg_starts), big) for p in sp]
    ucoord = []
    for i in range(nk):
        w = uq[i]
        ucoord.append(w >> 16)
        if 2 * i + 1 < d:
            ucoord.append((w & 0xFFFF) - (1 << 15))
    return (
        sorted_points,
        sorted_weights,
        seg_starts,
        seg_ends,
        offsets_t,
        m,
        uq,
        ucoord,
    )


def _blur_neighbor_queries(ucoord, d):
    """Packed neighbor-query keys: d+1 sets of ceil(d/2) int32 words.

    Set j asks for each vertex's n1 neighbor along lattice axis j
    (permutohedral.cpp:434-474): coordinate j steps by +d, every other
    coordinate by -1 (axis d's key is all -1). The n2 direction is the
    exact inverse — n2_j(n1_j(u)) == u coordinate-wise — so
    :func:`_blur_neighbors_sort` derives it by inverting the n1 map."""
    nk = (d + 1) // 2
    qpacked = []  # per set: nk packed key components
    for j in range(d + 1):
        qc = [ucoord[i] + (d if i == j else -1) for i in range(d)]
        packs_q = []
        for i in range(nk):
            hi = qc[2 * i]
            lo = (
                qc[2 * i + 1]
                if 2 * i + 1 < d
                else jnp.zeros_like(hi) - (1 << 15)
            )
            packs_q.append(_pack_pair16(hi, lo))
        qpacked.append(packs_q)
    return qpacked


def _blur_neighbors_sort(uq, ucoord, m, m_bucket, d):
    """Blur-neighbor resolution: ONE sort-merge for ALL 2*(d+1) query sets.

    A per-set binary search needs 16 dependent gather rounds x 14 sets =
    224 serialized rounds, each a latency-bound tiny-vector gather. One
    sort of a few hundred k rows replaces them: concatenate the unique keys (tag 0) with every
    query key (tag 1), sort once; in ascending order each query's
    predecessor-unique is found with a cummax over unique positions, and
    a key-equality check decides hit vs missing slot.

    Only the sign=+1 direction rides the sort: the two directions are
    exact inverses (n2_j(n1_j(u)) == u — coordinate j steps +d / others
    -1, then -d / +1), so n2 falls out of n1 by a collision-free scatter
    inversion, halving the merge-sort rows."""
    d1 = d + 1
    nk = (d + 1) // 2
    real = jnp.arange(m_bucket) < m  # padded vertices -> missing slot
    nq_sets = d1
    qpacked = _blur_neighbor_queries(ucoord, d)
    keys_cat = [
        jnp.concatenate([uq[i]] + [qp[i] for qp in qpacked])
        for i in range(nk)
    ]
    slot_ids = jnp.arange(m_bucket, dtype=jnp.int32)
    # The payload doubles as the unique-before-query tiebreak: unique rows
    # carry payload < m_bucket, query rows >= m_bucket, so sorting with the
    # payload as the FINAL key orders every equal-key group unique-first —
    # no separate tag operand rides the big sort.
    payload = jnp.concatenate(
        [slot_ids]
        + [slot_ids + (k + 1) * m_bucket for k in range(nq_sets)]
    )
    sorted_cat = jax.lax.sort(
        tuple(keys_cat) + (payload,), num_keys=nk + 1
    )
    # Gather-free match step: the naive form (cummax of unique row
    # indices, then gather each key word at the predecessor index and
    # compare) issues FOUR dynamic row-gathers over the merged stream.
    # Two invariants of this stream eliminate every gather:
    #   (1) the payload is the FINAL sort key, so within an equal-key run
    #       the unique row sorts FIRST, and a run holds at most one unique
    #       row (unique keys are deduped);
    #   (2) unique slot ids ascend with key order (assigned in sorted key
    #       order), so cummax of masked slot ids carries the slot of the
    #       most recent unique row.
    # A query matches iff the most recent unique row lies within its own
    # equal-key run: cummax(unique row idx) >= cummax(run-start idx), with
    # run starts from adjacent-row key inequality (contiguous shifts).
    spay = sorted_cat[nk]
    t_rows = spay.shape[0]
    iota_t = jnp.arange(t_rows, dtype=jnp.int32)
    is_u = spay < m_bucket
    neq_prev = jnp.zeros(t_rows, bool).at[0].set(True)
    for i in range(nk):
        k = sorted_cat[i]
        neq_prev = neq_prev | jnp.concatenate(
            [jnp.ones((1,), bool), k[1:] != k[:-1]]
        )
    rs_idx = jax.lax.cummax(jnp.where(neq_prev, iota_t, -1))
    u_idx = jax.lax.cummax(jnp.where(is_u, iota_t, -1))
    u_slot = jax.lax.cummax(jnp.where(is_u, spay, -1))
    match = (u_idx >= rs_idx) & (u_slot >= 0) & (u_slot < m)
    result = jnp.where(match, u_slot, m_bucket)
    # Route results back to (set, slot) order by sorting on the payload.
    back = jax.lax.sort((spay, result), num_keys=1)[1]
    blur_n1 = jnp.stack(
        [
            jnp.where(
                real,
                back[(j + 1) * m_bucket : (j + 2) * m_bucket],
                m_bucket,
            )
            for j in range(d1)
        ]
    )
    # n2 by inversion: n1_j(u) = v  <=>  n2_j(v) = u. Hits are real
    # vertex ids (< m) and n1_j is injective, so the scatter is
    # collision-free; misses (== m_bucket) drop out of bounds.
    src = jnp.broadcast_to(
        jnp.arange(m_bucket, dtype=jnp.int32)[None, :], (d1, m_bucket)
    ).reshape(-1)
    tgt = (
        jnp.arange(d1, dtype=jnp.int32)[:, None] * m_bucket + blur_n1
    ).reshape(-1)
    tgt = jnp.where(blur_n1.reshape(-1) < m_bucket, tgt, d1 * m_bucket)
    blur_n2 = (
        jnp.full((d1 * m_bucket,), m_bucket, jnp.int32)
        .at[tgt]
        .set(src, mode="drop")
        .reshape(d1, m_bucket)
    )
    blur_n2 = jnp.where(real[None, :], blur_n2, m_bucket)
    return blur_n1, blur_n2


def attach_sorted_stream(lattice: PermutohedralLattice) -> PermutohedralLattice:
    """Precompute the sorted splat stream for :func:`lattice_filter_t`.

    The N*(d+1) splat contributions are sorted by destination vertex on the
    host (once per map; the lattice itself is host-built anyway), turning
    the device splat from a scatter-add into a segment sum over contiguous
    runs: a cumsum plus two gathers of per-vertex prefix bounds. Call AFTER
    :func:`pad_lattice`
    (padded vertices get empty [start == end) segments).
    """
    if lattice.sorted_points is not None:
        return lattice
    n, d1 = lattice.offsets.shape
    flat = lattice.offsets.reshape(-1)
    perm = np.argsort(flat, kind="stable")
    sorted_ids = flat[perm]
    s = n * d1
    spad = -(-s // 128) * 128
    pts = (perm // d1).astype(np.int32)
    w = lattice.barycentric.reshape(-1)[perm].astype(np.float32)
    m = lattice.num_vertices
    # Prefix-row bounds: vertex v sums sorted rows [starts[v], ends[v]).
    starts = np.searchsorted(sorted_ids, np.arange(m), side="left")
    ends = np.searchsorted(sorted_ids, np.arange(m), side="right")
    lattice.sorted_points = np.pad(pts, (0, spad - s))
    lattice.sorted_weights = np.pad(w, (0, spad - s))
    lattice.seg_starts = starts.astype(np.int32)
    lattice.seg_ends = ends.astype(np.int32)
    return lattice


def segment_sum_sorted_t(
    contrib: jnp.ndarray,  # [C, S] stream sorted by segment
    starts: jnp.ndarray,  # [M] first row of each segment
    ends: jnp.ndarray,  # [M] one-past-last row
) -> jnp.ndarray:  # [C, M]
    """Scatter-free transposed segment sum (the lattice splat primitive).

    Two-level prefix over the sorted stream (cumsums within 128-element
    rows plus an exclusive carry of row totals), then per-segment range
    differences — no scatter. Shared by :func:`lattice_filter_t` and the
    sharded CRF paths. The float32 prefix puts vertex sums off by up to
    5.9e-4 (median sum 0.154) on a 30k-point map; on the CPU that changed
    no map label against float64 sums (PERF.md).
    """
    c, s = contrib.shape
    spad = -(-s // 128) * 128
    x = jnp.pad(contrib, ((0, 0), (0, spad - s))).reshape(c, spad // 128, 128)
    within = jnp.cumsum(x, axis=2)
    rowtot = within[:, :, -1]
    carry = jnp.cumsum(rowtot, axis=1) - rowtot  # exclusive row prefix
    prefix = (within + carry[:, :, None]).reshape(c, spad)[:, :s]
    prefix = jnp.concatenate(
        [jnp.zeros((c, 1), contrib.dtype), prefix], axis=1
    )
    return jnp.take(prefix, ends, axis=1) - jnp.take(prefix, starts, axis=1)



@partial(jax.jit, static_argnames=("num_vertices", "reverse"))
def lattice_filter_t(
    values_t: jnp.ndarray,  # [C, N] channels leading, points minor
    sorted_points: jnp.ndarray,  # [Spad]
    sorted_weights: jnp.ndarray,  # [Spad]
    seg_starts: jnp.ndarray,  # [M]
    seg_ends: jnp.ndarray,  # [M]
    offsets_t: jnp.ndarray,  # [d+1, N]
    barycentric_t: jnp.ndarray,  # [d+1, N]
    blur_n1: jnp.ndarray,  # [d+1, M]
    blur_n2: jnp.ndarray,  # [d+1, M]
    num_vertices: int,
    reverse: bool = False,
) -> jnp.ndarray:  # [C, N]
    """Transposed splat -> blur -> slice (permutohedral.cpp:476-527).

    Same math as :func:`lattice_filter` in the [C, N] layout: every tensor
    keeps the long dimension minor, and the splat scatter becomes a
    two-level cumsum over the sorted contribution stream plus two prefix
    gathers. Which layout is faster on the GPU is not measured yet
    (ROADMAP S7). Summation order within a vertex differs from
    the reference's point-order accumulation by f32 rounding only.
    """
    c, n = values_t.shape
    d1 = offsets_t.shape[0]
    m = num_vertices
    alpha = 1.0 / (1.0 + 2.0 ** (-(d1 - 1)))

    # Splat: gather contributions in sorted order, two-level prefix sum
    # (lane cumsum + row-total carry), per-vertex range differences.
    contrib = (
        jnp.take(values_t, sorted_points, axis=1) * sorted_weights[None, :]
    )  # [C, Spad]
    verts = segment_sum_sorted_t(contrib, seg_starts, seg_ends)  # [C, M]
    zero = jnp.zeros((c, 1), values_t.dtype)
    verts = jnp.concatenate([verts, zero], axis=1)  # slot m = missing

    # Blur: d+1 sequential passes; missing neighbors read the zero slot.
    axes = range(d1 - 1, -1, -1) if reverse else range(d1)
    for j in axes:
        n1v = jnp.take(verts, blur_n1[j], axis=1)
        n2v = jnp.take(verts, blur_n2[j], axis=1)
        verts = jnp.concatenate([verts[:, :m] + 0.5 * (n1v + n2v), zero], axis=1)

    # Slice.
    gathered = jnp.take(verts, offsets_t, axis=1)  # [C, d+1, N]
    return (gathered * barycentric_t[None, :, :]).sum(axis=1) * alpha


def differentiable_barycentric(
    features: jnp.ndarray,  # [N, d]
    rem0: jnp.ndarray,  # [N, d+1] the lattice build's remainder points
    rank: jnp.ndarray,  # [N, d+1]
) -> jnp.ndarray:  # [N, d+1] barycentric weights, differentiable in features
    """Barycentric weights as a differentiable function of the features.

    The reference's analytic feature gradient
    (``permutohedral.cpp:612-695``) differentiates the filter through the
    barycentric/elevation chain while holding the discrete lattice structure
    (vertex rounding and rank permutation) fixed; this is the same
    computation expressed for jax.grad: ``rem0``/``rank`` come from the host
    build and are treated as constants, the elevation is linear in the
    features, and the weight assembly (permutohedral.cpp:417-426) is
    differentiable arithmetic.
    """
    n, d = features.shape
    inv_std_dev = np.sqrt(2.0 / 3.0) * (d + 1)
    scale = jnp.asarray(
        (1.0 / np.sqrt((np.arange(d) + 2.0) * (np.arange(d) + 1.0)))
        * inv_std_dev,
        jnp.float32,
    )
    c = features * scale[None, :]
    suffix = jnp.concatenate(
        [
            jnp.cumsum(c[:, ::-1], axis=1)[:, ::-1],
            jnp.zeros((n, 1), jnp.float32),
        ],
        axis=1,
    )
    js = jnp.arange(1, d + 1, dtype=jnp.float32)
    elevated = jnp.concatenate(
        [suffix[:, :1], suffix[:, 1:] - js[None, :] * c], axis=1
    )

    down = 1.0 / (d + 1)
    v = (elevated - rem0) * down  # [N, d+1]
    idx = d - rank  # target slots in the d+2 accumulator
    bary = jnp.zeros((n, d + 2), jnp.float32)
    rows = jnp.broadcast_to(jnp.arange(n)[:, None], (n, d + 1))
    bary = bary.at[rows, idx].add(v)
    bary = bary.at[rows, idx + 1].add(-v)
    bary = bary.at[:, 0].add(1.0 + bary[:, d + 1])
    return bary[:, : d + 1]


def lattice_filter_differentiable(
    features: jnp.ndarray,  # [N, d]
    values: jnp.ndarray,  # [N, C]
    lattice: PermutohedralLattice,
) -> jnp.ndarray:
    """Gaussian filter differentiable w.r.t. the feature positions.

    jax.grad through this reproduces the reference's
    ``Permutohedral::gradient`` (d/df of a^T K b): gradients flow through
    the splat and slice barycentric weights; the vertex topology is fixed.
    """
    if lattice.rem0 is None:
        # The native builder doesn't export simplex geometry; rebuild with
        # the NumPy path (learning problems are small).
        lattice = build_lattice(np.asarray(features), use_native=False)
    bary = differentiable_barycentric(
        features,
        jnp.asarray(lattice.rem0),
        jnp.asarray(lattice.rank),
    )
    return lattice_filter(
        values,
        jnp.asarray(lattice.offsets),
        bary,
        jnp.asarray(lattice.blur_n1),
        jnp.asarray(lattice.blur_n2),
        lattice.num_vertices,
    )


def pad_lattice(
    lattice: PermutohedralLattice, bucket: int = 1 << 14
) -> PermutohedralLattice:
    """Pad the vertex count up to a size bucket so jitted filter shapes stay
    static across maps (each map has a different M; without bucketing every
    local map would trigger a recompile).

    Padded vertices have no splat contributions (no offsets point at them)
    and their blur neighbors are the zero slot, so they stay exactly zero
    through the blur passes and never affect real vertices.
    """
    m = lattice.num_vertices
    m_pad = bucket
    while m_pad < m:
        m_pad *= 2
    if m_pad == m:
        return lattice
    d1 = lattice.blur_n1.shape[0]
    pad = m_pad - m

    def pad_tbl(t: np.ndarray) -> np.ndarray:
        # Remap "missing" (== m) to the new zero slot (== m_pad); padded
        # vertices' neighbors are the zero slot.
        t = np.where(t == m, m_pad, t)
        return np.concatenate(
            [t, np.full((d1, pad), m_pad, t.dtype)], axis=1
        )

    return PermutohedralLattice(
        offsets=lattice.offsets,
        barycentric=lattice.barycentric,
        blur_n1=pad_tbl(lattice.blur_n1),
        blur_n2=pad_tbl(lattice.blur_n2),
        num_vertices=m_pad,
        dim=lattice.dim,
        rem0=lattice.rem0,
        rank=lattice.rank,
    )


def filter_ones_norm(lattice: PermutohedralLattice) -> np.ndarray:
    """The normalization vector: filter of all-ones (pairwise.cpp:44)."""
    ones = jnp.ones((lattice.offsets.shape[0], 1), jnp.float32)
    out = lattice_filter(
        ones,
        jnp.asarray(lattice.offsets),
        jnp.asarray(lattice.barycentric),
        jnp.asarray(lattice.blur_n1),
        jnp.asarray(lattice.blur_n2),
        lattice.num_vertices,
    )
    return np.asarray(out)[:, 0]

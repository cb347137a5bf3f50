"""Point-sharded dense-CRF mean-field: the long-context component.

The reference's only "sequence length" axis is the number of cloud points N
per local map, handled by the permutohedral lattice's O(N*(d+1)) filtering
(SURVEY.md §5). Scaling N beyond one chip mirrors context-parallel attention:

- the marginal matrix Q [N, C], the per-point simplex data (offsets,
  barycentric, norms) and the unaries shard along N over the mesh's point
  axis;
- lattice vertices [M+1, C] are the shared state: each device splats its
  point shard into a local vertex copy, a ``psum`` over the axis reduces the
  partial vertex values (the ring-exchange of vertex partials),
  the d+1 blur passes run replicated, and slicing back to points is local.

One psum of [M+1, C] per mean-field iteration is the only cross-chip
traffic; everything else stays on-shard. Replicating the vertex state is
the MEASURED right call for this problem's regime, not a shortcut: dense
clouds share vertices heavily (30k map points -> ~1-2k vertices, M << N),
so the psum is small next to the sharded Q, and a d=6 permutohedral
lattice does not partition with small halos at practical sizes — a 25k-
vertex 6-d cluster is nearly all surface, so a vertex-sharded halo
exchange moves MORE than the whole-table psum until M reaches tens of
millions (see ``parallel/sharded_lattice.py``, which implements the
vertex-sharded variant for that regime and reports both comm volumes).

Two implementations:

- :func:`sharded_potts_mean_field_t` — the production path: per-shard
  sorted-stream splat + transposed [C, N] layout (``lattice_filter_t``'s
  machinery per shard), blocks-fused multi-layer softmax, one
  ``psum([C, M+1])`` per iteration.
- :func:`sharded_potts_mean_field` — the original points-major variant,
  kept as the readable oracle.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding
from jax.sharding import PartitionSpec as P

from ..models.crf import exp_and_normalize
from ..models.lattice import PermutohedralLattice
from ..models.lattice import segment_sum_sorted_t as _seg_sum_t


def _blur(verts: jnp.ndarray, blur_n1: jnp.ndarray, blur_n2: jnp.ndarray,
          m: int) -> jnp.ndarray:
    d1 = blur_n1.shape[0]
    for j in range(d1):
        n1v = jnp.take(verts, blur_n1[j], axis=0)
        n2v = jnp.take(verts, blur_n2[j], axis=0)
        real = verts[:m] + 0.5 * (n1v + n2v)
        verts = jnp.concatenate(
            [real, jnp.zeros((1, verts.shape[1]), verts.dtype)], axis=0
        )
    return verts


def sharded_potts_mean_field(
    mesh: Mesh,
    axis: str,
    unary: np.ndarray,  # [N, C] energies (already -accumulated unaries)
    lattice: PermutohedralLattice,
    norm: np.ndarray,  # [N] symmetric normalization
    weight: float,
    n_iterations: int,
) -> np.ndarray:
    """Mean-field marginals with Q sharded along points over ``axis``.

    N is padded to the axis size with dummy isolated points (barycentric 0,
    all corners pointing at the zero slot), which contribute nothing to the
    vertex reduction.
    """
    n, c = unary.shape
    devices = mesh.shape[axis]
    m = lattice.num_vertices
    d1 = lattice.offsets.shape[1]
    alpha = 1.0 / (1.0 + 2.0 ** (-(d1 - 1)))

    n_pad = -(-n // devices) * devices
    pad = n_pad - n

    def pad0(a, value=0):
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        return np.pad(a, widths, constant_values=value)

    unary_p = pad0(np.asarray(unary, np.float32))
    offsets_p = pad0(lattice.offsets, value=m)  # pad corners -> zero slot
    bary_p = pad0(lattice.barycentric)  # zero weights
    norm_p = pad0(np.asarray(norm, np.float32))

    blur_n1 = jnp.asarray(lattice.blur_n1)
    blur_n2 = jnp.asarray(lattice.blur_n2)

    def step_fn(unary_s, offsets_s, bary_s, norm_s):
        # All arguments are per-shard [N/D, ...].
        def one_filter(q):
            contrib = (q * norm_s[:, None])[:, None, :] * bary_s[:, :, None]
            verts = jnp.zeros((m + 1, c), jnp.float32)
            verts = verts.at[offsets_s.reshape(-1)].add(
                contrib.reshape(-1, c)
            )
            verts = jax.lax.psum(verts, axis)  # vertex partial reduction
            verts = _blur(verts, blur_n1, blur_n2, m)
            gathered = jnp.take(verts, offsets_s, axis=0)
            out = (gathered * bary_s[:, :, None]).sum(axis=1) * alpha
            return out * norm_s[:, None]

        q = exp_and_normalize(-unary_s)

        def body(q, _):
            q_new = exp_and_normalize(-unary_s + weight * one_filter(q))
            return q_new, None

        q, _ = jax.lax.scan(body, q, None, length=n_iterations)
        return q

    shard = NamedSharding(mesh, P(axis))
    sharded = jax.shard_map(
        step_fn,
        mesh=mesh,
        in_specs=(P(axis), P(axis), P(axis), P(axis)),
        out_specs=P(axis),
    )
    q = sharded(
        jax.device_put(jnp.asarray(unary_p), shard),
        jax.device_put(jnp.asarray(offsets_p), shard),
        jax.device_put(jnp.asarray(bary_p), shard),
        jax.device_put(jnp.asarray(norm_p), shard),
    )
    return np.asarray(q)[:n]


def sharded_potts_mean_field_t(
    mesh: Mesh,
    axis: str,
    unary: np.ndarray,  # [N, Ctot] energies, all layers concatenated
    lattice: "PermutohedralLattice",
    weight: float,
    blocks: Tuple[int, ...],
    n_iterations: int,
) -> np.ndarray:
    """Transposed point-sharded mean-field — the production scale-out path.

    Same math as the serving hot path ``potts_mean_field_multi_t`` with N
    sharded over ``axis``: per shard, the splat is a SORTED segment sum of
    the shard's own contribution stream (host-prepared, no scatter), the
    [C, M+1] vertex table is psum-reduced once per filter, the blur runs on
    the reduced table, and the slice is shard-local. The symmetric
    normalization comes from a filtered ones-vector (pairwise.cpp:54-56).
    """
    n, ctot = unary.shape
    d = mesh.shape[axis]
    m = lattice.num_vertices
    d1 = lattice.offsets.shape[1]
    alpha = 1.0 / (1.0 + 2.0 ** (-(d1 - 1)))

    n_loc = -(-n // d)
    n_loc = -(-n_loc // 128) * 128

    # Host prep: per-shard sorted splat streams + transposed simplex data.
    streams = []
    for s in range(d):
        lo, hi = s * n_loc, min((s + 1) * n_loc, n)
        cnt = max(hi - lo, 0)
        dest = lattice.offsets[lo:hi].reshape(-1) if cnt > 0 else np.zeros(0, np.int64)
        w = lattice.barycentric[lo:hi].reshape(-1) if cnt > 0 else np.zeros(0, np.float32)
        pt = np.tile(np.arange(cnt)[:, None], (1, d1)).reshape(-1)
        perm = np.argsort(dest, kind="stable")
        dest, w, pt = dest[perm], w[perm], pt[perm]
        starts = np.searchsorted(dest, np.arange(m), side="left")
        ends = np.searchsorted(dest, np.arange(m), side="right")
        streams.append((pt, w.astype(np.float32), starts, ends))
    s_max = -(-max(max(len(t[0]) for t in streams), 1) // 128) * 128
    src = np.zeros((d, s_max), np.int32)
    wgt = np.zeros((d, s_max), np.float32)
    seg = np.zeros((d, 2, m), np.int32)
    for s, (pt, w, st, en) in enumerate(streams):
        src[s, : len(pt)] = pt
        wgt[s, : len(w)] = w
        seg[s, 0], seg[s, 1] = st, en

    offs_t = np.full((d, d1, n_loc), m, np.int32)  # pad -> zero slot
    bary_t = np.zeros((d, d1, n_loc), np.float32)
    u_t = np.zeros((d, ctot, n_loc), np.float32)
    for s in range(d):
        lo, hi = s * n_loc, min((s + 1) * n_loc, n)
        if hi > lo:
            offs_t[s, :, : hi - lo] = lattice.offsets[lo:hi].T
            bary_t[s, :, : hi - lo] = lattice.barycentric[lo:hi].T
            u_t[s, :, : hi - lo] = np.asarray(unary[lo:hi], np.float32).T

    blur_n1 = jnp.asarray(lattice.blur_n1)
    blur_n2 = jnp.asarray(lattice.blur_n2)
    wj = jnp.float32(weight)

    def filt(values_t, src_s, wgt_s, seg_s, offs_s, bary_s):
        verts = _seg_sum_t(
            jnp.take(values_t, src_s, axis=1) * wgt_s[None], seg_s[0], seg_s[1]
        )  # [C, M] partial
        verts = jax.lax.psum(verts, axis)
        c = values_t.shape[0]
        zero = jnp.zeros((c, 1), values_t.dtype)
        verts = jnp.concatenate([verts, zero], axis=1)
        for j in range(d1):
            n1v = jnp.take(verts, blur_n1[j], axis=1)
            n2v = jnp.take(verts, blur_n2[j], axis=1)
            verts = jnp.concatenate(
                [verts[:, :m] + 0.5 * (n1v + n2v), zero], axis=1
            )
        gathered = jnp.take(verts, offs_s.reshape(-1), axis=1).reshape(
            c, d1, -1
        )
        return (gathered * bary_s[None]).sum(axis=1) * alpha

    def block_softmax(t):
        outs = []
        start = 0
        for c in blocks:
            outs.append(exp_and_normalize(t[start : start + c].T).T)
            start += c
        return jnp.concatenate(outs, axis=0)

    def step_fn(u_s, src_s, wgt_s, seg_s, offs_s, bary_s):
        u_s, src_s, wgt_s = u_s[0], src_s[0], wgt_s[0]
        seg_s, offs_s, bary_s = seg_s[0], offs_s[0], bary_s[0]
        raw = filt(
            jnp.ones((1, u_s.shape[1]), jnp.float32),
            src_s, wgt_s, seg_s, offs_s, bary_s,
        )[0]
        norm = 1.0 / jnp.sqrt(raw + 1e-20)
        q = block_softmax(-u_s)

        def body(q, _):
            f = filt(q * norm[None], src_s, wgt_s, seg_s, offs_s, bary_s)
            return block_softmax(-u_s + wj * f * norm[None]), None

        q, _ = jax.lax.scan(body, q, None, length=n_iterations)
        return q[None]

    shard = NamedSharding(mesh, P(axis))
    sharded = jax.shard_map(
        step_fn,
        mesh=mesh,
        in_specs=(P(axis),) * 6,
        out_specs=P(axis),
    )
    q = sharded(
        jax.device_put(jnp.asarray(u_t), shard),
        jax.device_put(jnp.asarray(src), shard),
        jax.device_put(jnp.asarray(wgt), shard),
        jax.device_put(jnp.asarray(seg), shard),
        jax.device_put(jnp.asarray(offs_t), shard),
        jax.device_put(jnp.asarray(bary_t), shard),
    )  # [D, Ctot, n_loc]
    q = np.asarray(q).transpose(0, 2, 1).reshape(d * n_loc, ctot)
    return q[:n]

"""Integral-image surface normals (PCL AVERAGE_3D_GRADIENT port).

The reference computes per-pixel normals with
``pcl::IntegralImageNormalEstimation`` configured as AVERAGE_3D_GRADIENT,
``maxDepthChangeFactor = 0.02``, ``normalSmoothingSize = 10.0``
(``/root/reference/include/feature_extractor.h:254-262``), and consumes only
``acos(|n_z|)`` with NaN mapped to -2 (``feature_extractor.h:275-284``).

Semantics follow PCL 1.7's ``integral_image_normal.hpp`` as pinned by the
scalar oracle in ``tests/pcl_normals_oracle.py`` (PCL itself is absent in
this environment):

1. central-difference 3D gradients ``p(x+1) - p(x-1)`` / ``p(y+1) - p(y-1)``
   (no 0.5 — scale cancels in the normalization);
2. a depth-change map: right/lower neighbor pairs where
   ``|dz| > 0.02 * (|z|+1) * 2`` or either depth is non-finite mark BOTH
   pixels; pairs are only evaluated inside the image;
3. a two-pass CHAMFER distance transform (axial 1.0, diagonal 1.4) to the
   nearest change — the row recurrences run as ``lax.scan`` over rows with
   the in-row left/right chains expressed as cumulative minima of ``v - x``;
4. per-pixel ``smoothing = min(distance, normal_smoothing_size)``; pixels
   with ``smoothing <= 2`` or non-finite depth are NaN; the averaging
   window is ``rect = int(smoothing)`` wide spanning
   ``[pos - rect/2, pos - rect/2 + rect)`` per axis (truncated, right-open
   — even rects give asymmetric windows), and a frame of
   ``border = int(normal_smoothing_size)`` pixels is skipped entirely;
5. masked box-sums of both gradients over the per-pixel window; ``rect``
   takes at most 9 distinct values (2..10 for the default 10.0), so on the
   stride grid each rect's box sum is four contiguous slices of PHASE-SPLIT
   padded integral images (one strided split into s*s phase sub-images up
   front; every corner read is then a contiguous ``dynamic_slice``),
   selected by a ``rect == r`` mask. No gathers. All four integrals ride one 8-channel stack so the whole box
   sum is one slice expression;
6. normal ~ cross(grad_y_sum, grad_x_sum); windows with no finite elements
   in either gradient or a zero-length cross give NaN. Only ``|n_z|`` is
   consumed downstream, so the cross orientation/viewpoint flip are
   irrelevant.
"""

from __future__ import annotations

from functools import partial
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def _row_chain_min(cand: jnp.ndarray, reverse: bool) -> jnp.ndarray:
    """In-row relaxation by +1.0 steps: out[x] = min_j<=x (cand[j] + (x-j)).

    ``reverse`` chains right-to-left instead. Exactly PCL's sequential
    ``cur[x] = min(base[x], cur[x-1] + 1)`` recurrence, vectorized.
    """
    w = cand.shape[-1]
    x = jnp.arange(w, dtype=cand.dtype)
    if reverse:
        return jnp.flip(_row_chain_min(jnp.flip(cand, -1), False), -1)
    return jax.lax.cummin(cand - x, axis=cand.ndim - 1) + x


def _chamfer_passes(d0: jnp.ndarray, big) -> jnp.ndarray:
    """The two restricted chamfer passes over [..., R, W] row stacks.

    Leading dimensions (row bands, batch) ride along; the scan is over the
    row axis (-2). Column 0 and w-1 are never relaxed (PCL's passes loop
    x in [1, w-2]); the first row is only touched by the backward pass,
    the last only by the forward pass.
    """
    w = d0.shape[-1]
    r = d0.shape[-2]
    inner = (jnp.arange(w) >= 1) & (jnp.arange(w) <= w - 2)
    is_first = jnp.arange(w) == 0
    is_last = jnp.arange(w) == w - 1

    def shift_l(row):  # row[x+1]
        return jnp.concatenate(
            [row[..., 1:], jnp.full(row.shape[:-1] + (1,), big)], axis=-1
        )

    def shift_r(row):  # row[x-1]
        return jnp.concatenate(
            [jnp.full(row.shape[:-1] + (1,), big), row[..., :-1]], axis=-1
        )

    def relax(prev, cur0, reverse):
        vert = jnp.minimum(
            prev + 1.0,
            jnp.minimum(shift_r(prev) + 1.4, shift_l(prev) + 1.4),
        )
        base = jnp.minimum(cur0, vert)
        feed = is_last if reverse else is_first
        cand = jnp.where(inner, base, jnp.where(feed, cur0, big))
        chained = _row_chain_min(cand, reverse=reverse)
        return jnp.where(inner, jnp.minimum(base, chained), cur0)

    rows = jnp.moveaxis(d0, -2, 0)  # [R, ..., W] for the scan

    def fwd_step(prev, cur0):
        cur = relax(prev, cur0, reverse=False)
        return cur, cur

    _, rows_f = jax.lax.scan(fwd_step, rows[0], rows[1:])
    df = jnp.concatenate([rows[0][None], rows_f], axis=0)

    def bwd_step(prev, cur0):
        cur = relax(prev, cur0, reverse=True)
        return cur, cur

    _, rows_b = jax.lax.scan(bwd_step, df[r - 1], jnp.flip(df[: r - 1], 0))
    out = jnp.concatenate([jnp.flip(rows_b, 0), df[r - 1][None]], axis=0)
    return jnp.moveaxis(out, 0, -2)


def _chamfer_iter(change: jnp.ndarray, saturation: float) -> jnp.ndarray:
    """Saturated chamfer by iterated 3x3 min-plus relaxation.

    The consumer clamps ``smoothing = min(distance, s)`` and masks an
    ``int(s)``-pixel border frame, so only values strictly below ``s`` at
    pixels >= ceil(s) from every edge have to be exact. Any chamfer path
    of cost < s takes at most ceil(s)-1 unit-or-diagonal steps (every step
    costs >= 1.0), so ceil(s) rounds of the full 3x3 relaxation
    ``d <- min(d, axial+1.0, diagonal+1.4)`` resolve all of them exactly;
    everything else stays pinned at the initial value ``s`` (values only
    decrease below s when a real shorter path exists). Columns 0 and w-1
    are re-pinned to their seed every round — PCL's restricted passes
    never relax them (they loop x in [1, w-2]), and their frozen values
    feed the in-row chains, which the pinning reproduces — so the result
    clamps identically to the sequential passes at EVERY column of every
    row >= ceil(s) from the top/bottom edge (pinned by
    TestDistanceTransform).

    Unlike the full-height row scan (2x(H-1) sequential steps, each with an
    in-row cummin chain) this is ceil(s) (= 10 for the config default)
    dependent rounds of pure elementwise shifts/mins on the [H, W] image.
    """
    h, w = change.shape
    sat = jnp.float32(saturation)
    seed = jnp.where(change, 0.0, sat).astype(jnp.float32)
    edge_col = (jnp.arange(w) == 0) | (jnp.arange(w) == w - 1)

    def shifted(a, dy, dx):
        # Out-of-image neighbors contribute >= sat (never win after +cost).
        out = jnp.roll(a, (dy, dx), (0, 1))
        if dy:
            row = 0 if dy > 0 else h - 1
            out = out.at[row].set(sat)
        if dx:
            col = 0 if dx > 0 else w - 1
            out = out.at[:, col].set(sat)
        return out

    d = seed
    for _ in range(int(np.ceil(saturation))):
        relaxed = jnp.minimum(
            jnp.minimum(
                jnp.minimum(shifted(d, 0, 1), shifted(d, 0, -1)),
                jnp.minimum(shifted(d, 1, 0), shifted(d, -1, 0)),
            )
            + 1.0,
            jnp.minimum(
                jnp.minimum(shifted(d, 1, 1), shifted(d, 1, -1)),
                jnp.minimum(shifted(d, -1, 1), shifted(d, -1, -1)),
            )
            + 1.4,
        )
        d = jnp.where(edge_col, seed, jnp.minimum(d, relaxed))
    return d


def chamfer_distance_map(
    change: jnp.ndarray,
    saturation: Optional[float] = None,
) -> jnp.ndarray:
    """PCL's two-pass chamfer (1.0/1.4) distance to the change pixels.

    With ``saturation=s`` the consumer only distinguishes values < s (PCL
    clamps ``smoothing = min(distance, s)``) outside an ``int(s)`` border
    frame, so ceil(s) rounds of 3x3 min-plus relaxation suffice (see
    :func:`_chamfer_iter`); saturated values outside the clamp or inside
    the top/bottom image border may differ from the sequential passes.
    Exact (unsaturated) callers get the full-height scan.
    """
    if saturation is not None:
        return _chamfer_iter(change, saturation)
    h, w = change.shape
    big = jnp.float32(h + w)
    d0 = jnp.where(change, 0.0, big).astype(jnp.float32)
    return _chamfer_passes(d0, big)


def _shift(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """Shift with NaN fill (treats out-of-image neighbors as invalid)."""
    out = jnp.roll(a, shift=(dy, dx), axis=(0, 1))
    h, w = a.shape[0], a.shape[1]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    bad = (ys - dy < 0) | (ys - dy >= h) | (xs - dx < 0) | (xs - dx >= w)
    if a.ndim == 3:
        bad = bad[..., None]
    return jnp.where(bad, jnp.nan, out)


def _shift_c(a: jnp.ndarray, dy: int, dx: int) -> jnp.ndarray:
    """:func:`_shift` for channel-LEADING [C, H, W] stacks."""
    out = jnp.roll(a, shift=(dy, dx), axis=(1, 2))
    h, w = a.shape[1], a.shape[2]
    ys = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)
    bad = (ys - dy < 0) | (ys - dy >= h) | (xs - dx < 0) | (xs - dx >= w)
    return jnp.where(bad[None], jnp.nan, out)


def _masked_integral(a: jnp.ndarray) -> jnp.ndarray:
    """Zero-padded 2D inclusive prefix sums with a leading zero row/col."""
    s = jnp.cumsum(jnp.cumsum(a, axis=0), axis=1)
    s = jnp.pad(s, [(1, 0), (1, 0)] + [(0, 0)] * (a.ndim - 2))
    return s


def _box_sum_gather(integral: jnp.ndarray, y0, y1, x0, x1) -> jnp.ndarray:
    """Sum over the inclusive window [y0..y1] x [x0..x1] per pixel."""
    return (
        integral[y1 + 1, x1 + 1]
        - integral[y0, x1 + 1]
        - integral[y1 + 1, x0]
        + integral[y0, x0]
    )


@partial(
    jax.jit,
    static_argnames=("max_depth_change_factor", "normal_smoothing_size"),
)
def normal_angles(
    points: jnp.ndarray,
    max_depth_change_factor: float = 0.02,
    normal_smoothing_size: float = 10.0,
) -> jnp.ndarray:
    """Full-resolution angles [H, W] (see :func:`normal_angles_grid`)."""
    return _normal_angles_impl(
        points, None, max_depth_change_factor, normal_smoothing_size
    )


@partial(
    jax.jit,
    static_argnames=(
        "stride", "max_depth_change_factor", "normal_smoothing_size",
    ),
)
def normal_angles_grid(
    points: jnp.ndarray,  # [H, W, 3]
    stride: int,
    max_depth_change_factor: float = 0.02,
    normal_smoothing_size: float = 10.0,
) -> jnp.ndarray:  # [ceil(H/s), ceil(W/s)]
    """Angles only at the stride-grid samples.

    Integral images and the distance transform still run at full resolution
    (their windows span full-res data), but everything per-point runs only
    at the consumed grid pixels (feature_extractor.h:269-289), and the box
    sums use the static-rect phase-split formulation (no gathers).
    """
    return _normal_angles_impl(
        points, stride, max_depth_change_factor, normal_smoothing_size
    )


def _normal_angles_impl(
    points, stride: Optional[int], max_depth_change_factor,
    normal_smoothing_size,
):
    h, w = points.shape[0], points.shape[1]
    z = points[..., 2]
    invalid = jnp.isnan(z)
    ys_full = jax.lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs_full = jax.lax.broadcasted_iota(jnp.int32, (h, w), 1)

    # --- depth-change map: pairs (x, x+1) / (y, y+1) evaluated inside the
    # image; either non-finite depth or |dz| over threshold marks BOTH.
    thresh = max_depth_change_factor * (jnp.abs(z) + 1.0) * 2.0
    z_r = _shift(z, 0, -1)  # right neighbor
    z_d = _shift(z, -1, 0)  # below neighbor
    change_x = (xs_full < w - 1) & (
        invalid | jnp.isnan(z_r) | (jnp.abs(z - z_r) > thresh)
    )
    change_y = (ys_full < h - 1) & (
        invalid | jnp.isnan(z_d) | (jnp.abs(z - z_d) > thresh)
    )
    change = (
        change_x
        | change_y
        | jnp.roll(change_x, 1, axis=1)  # partner x+1 (col w-1 never wraps)
        | jnp.roll(change_y, 1, axis=0)  # partner y+1
    )

    # The saturated chamfer is exact ceil(smoothing) rows from the edge
    # while the consumer masks an int(smoothing) border; integral sizes
    # (the config default 10.0) make those agree. Non-integral sizes take
    # the exact full-height scan.
    integral_size = float(normal_smoothing_size) == int(normal_smoothing_size)
    distance = chamfer_distance_map(
        change, saturation=normal_smoothing_size if integral_size else None
    )

    border = int(normal_smoothing_size)
    rect_max = int(normal_smoothing_size)  # rects take values 2..rect_max
    rmax = rect_max // 2

    if stride is not None:
        s = stride
        gh, gw = -(-h // s), -(-w // s)
        distance_g = distance[::s, ::s]
        invalid_g = invalid[::s, ::s]
        smoothing = jnp.minimum(distance_g, normal_smoothing_size)
        rect = smoothing.astype(jnp.int32)  # int() truncation

        # One CHANNEL-LEADING 8-stack [8, h, w]: grad_x (3), grad_y (3),
        # count_x, count_y; the image width stays the minor axis of every
        # cumsum/select.
        pts_t = jnp.moveaxis(points, -1, 0)  # [3, h, w]
        gx_t = _shift_c(pts_t, 0, -1) - _shift_c(pts_t, 0, 1)
        gy_t = _shift_c(pts_t, -1, 0) - _shift_c(pts_t, 1, 0)
        gx_valid = ~jnp.isnan(gx_t[0])
        gy_valid = ~jnp.isnan(gy_t[0])
        stack = jnp.concatenate(
            [
                jnp.nan_to_num(gx_t),
                jnp.nan_to_num(gy_t),
                gx_valid[None].astype(jnp.float32),
                gy_valid[None].astype(jnp.float32),
            ],
            axis=0,
        )
        integ = jnp.cumsum(jnp.cumsum(stack, axis=1), axis=2)
        integ = jnp.pad(integ, [(0, 0), (1, 0), (1, 0)])  # [8, h+1, w+1]
        # Pad so every phase sub-image holds the full [offset + gh/gw]
        # extent (edge replication keeps clamp semantics; out-of-image rows
        # are never selected: the border frame is masked below).
        off = (2 * rmax + 1) // s
        back_y = max(rmax + 1, (off + gh) * s - (h + 1) - rmax)
        back_x = max(rmax + 1, (off + gw) * s - (w + 1) - rmax)
        ip = jnp.pad(
            integ, [(0, 0), (rmax, back_y), (rmax, back_x)], mode="edge"
        )
        # Split into s*s phase sub-images once; every corner read below is
        # then a contiguous dynamic_slice (lane-strided slices per corner
        # cost a relayout per element and were 8x slower at stride 2).
        phases = [
            [ip[:, py::s, px::s] for px in range(s)] for py in range(s)
        ]

        def corner(dy, dx):
            g0, g1 = rmax + dy, rmax + dx
            ph = phases[g0 % s][g1 % s]
            return jax.lax.dynamic_slice(
                ph, (0, g0 // s, g1 // s), (8, gh, gw)
            )

        acc = jnp.zeros((8, gh, gw), jnp.float32)
        for r in range(2, rect_max + 1):
            # Window [pos - r//2, pos - r//2 + r) inclusive-exclusive.
            d0 = -(r // 2)
            d1 = d0 + r  # exclusive -> integral corner offset
            box = (
                corner(d1, d1)
                - corner(d0, d1)
                - corner(d1, d0)
                + corner(d0, d0)
            )
            acc = jnp.where((rect == r)[None], box, acc)
        sum_gx = jnp.moveaxis(acc[0:3], 0, -1)  # [gh, gw, 3]
        sum_gy = jnp.moveaxis(acc[3:6], 0, -1)
        cnt_x, cnt_y = acc[6], acc[7]
        invalid = invalid_g
        ys_g = jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 0) * s
        xs_g = jax.lax.broadcasted_iota(jnp.int32, (gh, gw), 1) * s
    else:
        # --- central-difference 3D gradients (PCL keeps sums unscaled).
        grad_x = _shift(points, 0, -1) - _shift(points, 0, 1)
        grad_y = _shift(points, -1, 0) - _shift(points, 1, 0)
        gx_valid = ~jnp.isnan(grad_x[..., 0])
        gy_valid = ~jnp.isnan(grad_y[..., 0])
        grad_x = jnp.nan_to_num(grad_x)
        grad_y = jnp.nan_to_num(grad_y)
        ix = _masked_integral(grad_x)
        iy = _masked_integral(grad_y)
        icx = _masked_integral(gx_valid.astype(jnp.float32))
        icy = _masked_integral(gy_valid.astype(jnp.float32))
        smoothing = jnp.minimum(distance, normal_smoothing_size)
        rect = smoothing.astype(jnp.int32)
        r2 = rect // 2
        y0 = jnp.clip(ys_full - r2, 0, h - 1)
        y1 = jnp.clip(ys_full - r2 + rect - 1, 0, h - 1)
        x0 = jnp.clip(xs_full - r2, 0, w - 1)
        x1 = jnp.clip(xs_full - r2 + rect - 1, 0, w - 1)
        sum_gx = _box_sum_gather(ix, y0, y1, x0, x1)
        sum_gy = _box_sum_gather(iy, y0, y1, x0, x1)
        cnt_x = _box_sum_gather(icx, y0, y1, x0, x1)
        cnt_y = _box_sum_gather(icy, y0, y1, x0, x1)
        ys_g, xs_g = ys_full, xs_full

    normal = jnp.cross(sum_gy, sum_gx)
    norm = jnp.linalg.norm(normal, axis=-1)

    ok = (
        (smoothing > 2.0)  # PCL's minimum-window gate
        & ~invalid
        & (cnt_x > 0)
        & (cnt_y > 0)
        & (norm > 0)
        # PCL skips a border = int(normal_smoothing_size) frame outright.
        & (ys_g >= border)
        & (ys_g < h - border)
        & (xs_g >= border)
        & (xs_g < w - border)
    )
    nz = jnp.abs(normal[..., 2]) / jnp.maximum(norm, 1e-20)
    angle = jnp.arccos(jnp.clip(nz, 0.0, 1.0))
    return jnp.where(ok, angle, jnp.float32(-2.0))  # feature_extractor.h:277

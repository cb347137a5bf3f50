"""2D dense-CRF demo path with the WHOLE problem built on device.

``cli/dense_inference`` parity target: the reference binary runs the
320x240x21 demo in 214-303 ms in-env
(``/root/reference/third-party/densecrf/examples/dense_inference.cpp:86-101``).
After fusing the mean-field loop into one dispatch (models/crf.py), the
host lattice builds remain, with their upload: offsets/barycentric/blur
tables for the grid (d=2) and bilateral (d=5) kernels are ~5.5 MB at 76.8k
points.

This module uploads only the [H, W, 3] uint8 image (230 KB) and the [N]
int8 annotation labels (77 KB): pairwise features (densecrf.cpp:61-81),
both permutohedral lattices (``build_lattice_device``), the symmetric
normalizations (pairwise.cpp:46-61), the unary energies
(dense_inference.cpp:37-52), the mean-field loop (densecrf.cpp:115-131)
and the MAP argmax (:202-211) all run inside ONE jitted dispatch in the
transposed [C, N] layout (``lattice_filter_t``, the map-path CRF's).

Numerics: the sorted-stream splat sums vertex contributions in sorted
rather than point order, so marginals differ from the host-built path by
f32 rounding only; the compiled-reference golden outputs remain
pixel-identical on all three demo pairs (tests/test_crf_learning.py).
``cli/dense_inference.run(device_build=True)`` takes this path; the host
build stays the default until ``scripts/bench_dense_inference.py``, which
times both and checks golden parity, shows this one faster on the GPU.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .lattice import build_lattice_device, lattice_filter_t


@partial(
    jax.jit,
    static_argnames=(
        "h", "w", "num_labels", "n_iterations", "m_buckets", "params"
    ),
)
def _dense2d_device_impl(
    im: jnp.ndarray,  # [H, W, 3] uint8
    labels: jnp.ndarray,  # [N] int8/int32, -1 = unknown
    energies: jnp.ndarray,  # [3] f32 (u, n, p)
    h: int,
    w: int,
    num_labels: int,
    n_iterations: int,
    m_buckets: Tuple[int, int],
    params: Tuple[Tuple[float, ...], Tuple[float, ...]],
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One dispatch: features -> lattices -> norms -> mean field -> MAP.

    ``params`` = ((sx, sy, w_gauss), (bsx, bsy, sr, sg, sb, w_bilat)) —
    the demo's Potts weights and kernel scales (dense_inference.cpp:83-97).
    Returns (map_labels [N] i32, vertex_counts [2] i32); callers must
    check counts <= m_buckets and retry with larger buckets on overflow
    (the padded build contract, build_lattice_device).
    """
    (sx, sy, wg), (bsx, bsy, sr, sg, sb, wb) = params
    n = h * w
    xs = jnp.tile(jnp.arange(w, dtype=jnp.float32), h)  # meshgrid 'xy' ravel
    ys = jnp.repeat(jnp.arange(h, dtype=jnp.float32), w)
    rgb = im.reshape(n, 3).astype(jnp.float32)
    feats_g = jnp.stack([xs / sx, ys / sy], axis=1)
    feats_b = jnp.stack(
        [xs / bsx, ys / bsy, rgb[:, 0] / sr, rgb[:, 1] / sg, rgb[:, 2] / sb],
        axis=1,
    )
    kernels = []
    counts = []
    for feats, bucket, weight in (
        (feats_g, m_buckets[0], wg),
        (feats_b, m_buckets[1], wb),
    ):
        built = build_lattice_device(feats, m_bucket=bucket)
        counts.append(built[-1])
        # Symmetric normalization (pairwise.cpp:46-53): filter of all-ones.
        raw = lattice_filter_t(
            jnp.ones((1, n), jnp.float32), *built[:8], bucket
        )[0]
        norm = 1.0 / jnp.sqrt(raw + 1e-20)
        kernels.append((built[:8], bucket, norm, weight))

    # Unary energies from the label map (dense_inference.cpp:37-52), [C, N].
    lab = labels.astype(jnp.int32)
    u_e, n_e, p_e = (energies[i] for i in range(3))
    base = jnp.where(lab >= 0, n_e, u_e)[None, :]
    onehot = lab[None, :] == jnp.arange(num_labels, dtype=jnp.int32)[:, None]
    unary_t = jnp.where(onehot, p_e, base)  # [C, N]

    def softmax_t(x):
        x = x - jnp.max(x, axis=0, keepdims=True)
        e = jnp.exp(x)
        return e / jnp.sum(e, axis=0, keepdims=True)

    q0 = softmax_t(-unary_t)

    def body(_, q):
        tmp = -unary_t
        for built8, bucket, norm, weight in kernels:
            out = q * norm[None, :]
            out = lattice_filter_t(out, *built8, bucket)
            out = out * norm[None, :]
            # Potts apply is -w*out; the step subtracts it (densecrf.cpp:121).
            tmp = tmp + weight * out
        return softmax_t(tmp)

    q = jax.lax.fori_loop(0, n_iterations, body, q0)
    map_labels = jnp.argmax(q, axis=0).astype(jnp.int32)  # first max, :202-211
    return map_labels, jnp.stack([c.astype(jnp.int32) for c in counts])


def dense2d_map_from_labels_device(
    im: np.ndarray,  # [H, W, 3] uint8
    labels: np.ndarray,  # [N] int, -1 = unknown
    energies: Tuple[float, float, float],
    num_labels: int,
    n_iterations: int,
    gauss: Tuple[float, float, float] = (3.0, 3.0, 3.0),
    bilateral: Tuple[float, ...] = (80.0, 80.0, 13.0, 13.0, 13.0, 10.0),
    m_bucket: int = 1 << 14,
) -> np.ndarray:
    """Host wrapper: bucket-retry loop around the one-dispatch demo path.

    The measured demo images need <= 16k vertices per kernel (grid ~10k,
    bilateral ~7-16k at 320x240); a x4 bucket escalation re-runs only on
    overflow, mirroring the map pipeline's bucket validation.
    """
    h, w = im.shape[:2]
    im_dev = jnp.asarray(np.ascontiguousarray(im))
    lab_dev = jnp.asarray(
        np.asarray(labels).astype(np.int8 if num_labels < 128 else np.int32)
    )
    e_dev = jnp.asarray(np.asarray(energies, np.float32))
    buckets = [m_bucket, m_bucket]
    while True:
        out, counts = _dense2d_device_impl(
            im_dev, lab_dev, e_dev, h=h, w=w, num_labels=num_labels,
            n_iterations=n_iterations, m_buckets=tuple(buckets),
            params=(tuple(map(float, gauss)), tuple(map(float, bilateral))),
        )
        counts_np = np.asarray(counts)  # the one host sync
        over = counts_np > np.asarray(buckets)
        if not over.any():
            return np.asarray(out)
        for k in np.nonzero(over)[0]:
            buckets[int(k)] *= 4

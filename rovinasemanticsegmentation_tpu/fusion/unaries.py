"""Accumulation of per-frame posteriors into per-point map unaries.

Scatter-add equivalent of the fusion inner loop
(``/root/reference/src/segmenter.cpp:599-616``): for each camera's index
image, every pixel that hit a cloud point adds its per-class posterior to
that point's unary row. Missing frames simply contribute nothing
(``segmenter.cpp:618-621`` tolerates patches without semantics).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("num_points",))
def accumulate_unaries(
    unaries: jnp.ndarray,  # [N, C] running accumulator
    posterior: jnp.ndarray,  # [H, W, C] full-res per-class posterior
    index_image: jnp.ndarray,  # [H, W] int32 cloud index or -1
    num_points: int,
) -> jnp.ndarray:
    c = posterior.shape[-1]
    idx = index_image.reshape(-1)
    vals = posterior.reshape(-1, c)
    safe = jnp.where(idx >= 0, idx, num_points)  # dump misses into a pad row
    padded = jnp.zeros((num_points + 1, c), unaries.dtype)
    padded = padded.at[safe].add(vals)
    return unaries + padded[:num_points]

"""Random-forest descent as a Pallas kernel for the GPU (Triton route).

The plain form, :func:`models.forest._find_leaves_packed`, is a
``lax.while_loop`` over tree levels whose predicate depends on the data;
every level runs as separate XLA kernels plus a device-to-host copy of the
predicate. This kernel keeps the whole descent of a block of points on the
chip instead:

- one program per power-of-two block of points; each of the T trees' node
  ids for the block lives in registers;
- the level loop runs inside the kernel, ``max_depth`` levels;
- node records (the packed ``feat | left << bits`` word and the threshold
  bits, :func:`models.forest.pack_node_records`, a few hundred KB for a
  trained forest, so they stay in L2) and ``x[p, f]`` are fetched with
  gather loads.

The leaf ids are the original node numbering, so the leaf histograms are
gathered exactly as after the plain descent.

:func:`select_descent` picks the descent once per pipeline from the
platform it runs on; the CPU takes the plain path, and the kernel runs
there only when a caller asks for ``interpret=True``.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from ..models.forest import _find_leaves_packed

DESCENTS = ("xla", "triton")

#: Points per program and warps per program of the descent kernel, the
#: fastest of 32..256 points and 1..8 warps on an H100 (PERF.md).
BLOCK = 32
NUM_WARPS = 1


def select_descent(platform: str) -> str:
    """The descent a pipeline on ``platform`` runs: the kernel on the GPU,
    the plain XLA loop on the CPU (tests). Any other platform is an error."""
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise ValueError(f"no forest descent for platform {platform!r}")


def _descent_kernel(
    x_ref,  # [P * D] f32 features, row-major
    rec_ref,  # [T * N * 2] i32 packed node records
    out_ref,  # [T, block] i32 leaf ids of this program's points
    *,
    num_trees: int,
    num_nodes: int,
    num_points: int,
    num_features: int,
    max_depth: int,
    feat_bits: int,
    block: int,
):
    pid = pl.program_id(0)
    p = pid * block + jnp.arange(block, dtype=jnp.int32)
    # Padding points re-read the last row; their ids are sliced off.
    row = jnp.minimum(p, num_points - 1) * num_features
    fmask = (1 << feat_bits) - 1

    def level(_, nodes):
        new_nodes = []
        for t in range(num_trees):
            r = (t * num_nodes + nodes[t]) * 2
            meta = plgpu.load(rec_ref.at[r])
            thr = jax.lax.bitcast_convert_type(
                plgpu.load(rec_ref.at[r + 1]), jnp.float32
            )
            lc = meta >> feat_bits
            x = plgpu.load(x_ref.at[row + (meta & fmask)])
            nxt = lc + (x >= thr).astype(jnp.int32)  # x < thr -> left
            new_nodes.append(jnp.where(lc == 0, nodes[t], nxt))
        return tuple(new_nodes)

    # A fixed trip count. Points already on a leaf re-read their leaf record
    # and feature, which the caches serve. A lax.while_loop that stops once
    # the block sits on leaves compiles (scripts/probe_triton_while.py) but
    # ran no faster at 32 points per block and slower at 64-256 on an H100
    # (PERF.md): a block ends with the deepest of its 4 x 32 paths.
    nodes = tuple(jnp.zeros((block,), jnp.int32) for _ in range(num_trees))
    nodes = jax.lax.fori_loop(0, max_depth, level, nodes)
    for t in range(num_trees):
        plgpu.store(out_ref.at[t, :], nodes[t])


@partial(
    jax.jit,
    static_argnames=("max_depth", "feat_bits", "block", "num_warps", "interpret"),
)
def find_leaves_triton(
    features: jnp.ndarray,  # [P, D] f32
    records: jnp.ndarray,  # [T, N, 2] i32 packed node records
    max_depth: int,
    feat_bits: int,
    block: int = BLOCK,
    num_warps: int = NUM_WARPS,
    interpret: bool = False,
) -> jnp.ndarray:  # [P, T] i32 leaf node ids
    """The kernel's leaves; equal to :func:`_find_leaves_packed`'s."""
    p, d = features.shape
    t_count, n_nodes, _ = records.shape
    grid = -(-p // block)
    out = pl.pallas_call(
        partial(
            _descent_kernel,
            num_trees=t_count,
            num_nodes=n_nodes,
            num_points=p,
            num_features=d,
            max_depth=max_depth,
            feat_bits=feat_bits,
            block=block,
        ),
        out_shape=jax.ShapeDtypeStruct((t_count, grid * block), jnp.int32),
        grid=(grid,),
        in_specs=[
            pl.BlockSpec(memory_space=pl.ANY),
            pl.BlockSpec(memory_space=pl.ANY),
        ],
        out_specs=pl.BlockSpec((t_count, block), lambda i: (0, i)),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=num_warps),
        interpret=interpret,
        name="forest_descent",
    )(features.reshape(-1), records.reshape(-1))
    return out[:, :p].T


def find_leaves(
    features: jnp.ndarray,
    records: jnp.ndarray,
    *,
    max_depth: int,
    feat_bits: int,
    descent: str,
    interpret: bool = False,
) -> jnp.ndarray:
    """[P, D] -> [P, T] leaf ids through the named descent."""
    if descent == "triton":
        return find_leaves_triton(
            features, records, max_depth, feat_bits, interpret=interpret
        )
    if descent == "xla":
        return _find_leaves_packed(features, records, max_depth, feat_bits)
    raise ValueError(f"unknown descent {descent!r}; expected one of {DESCENTS}")

"""Dense CRF with mean-field inference over point clouds and images.

Capability parity with the Krähenbühl/Koltun engine
(``/root/reference/third-party/densecrf/src/densecrf.cpp``,
``src/pairwise.cpp``, ``src/labelcompatibility.cpp``), re-designed so the
mean-field loop is one jitted device computation:

- ``Q = expAndNormalize(-U - sum_k compat_k(kernel_k(Q)))`` per iteration
  (densecrf.cpp:115-131) with the max-subtracted softmax (:98-106);
- pairwise kernels are permutohedral lattice filters with NO / BEFORE /
  AFTER / SYMMETRIC normalization (pairwise.cpp:40-80); SYMMETRIC is the
  default, as in the reference headers;
- Potts (``-w*Q``), diagonal (``diag(v)*Q``) and symmetric matrix (``M*Q``)
  label compatibilities (labelcompatibility.cpp:44-108);
- ``map`` = per-point argmax of the marginals (densecrf.cpp:202-211);
- KL divergence of marginals for diagnostics (densecrf.cpp:214-235).

Data layout is points-major ``[N, C]`` (the reference is ``[C, N]``
column-major — identical memory meaning, friendlier gathers here).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from functools import partial
from typing import List, Optional, Sequence, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from .lattice import PermutohedralLattice, build_lattice, lattice_filter


class NormalizationType(enum.Enum):
    NO_NORMALIZATION = 0
    NORMALIZE_BEFORE = 1
    NORMALIZE_AFTER = 2
    NORMALIZE_SYMMETRIC = 3


# ----------------------------------------------------------------------
# Label compatibilities
# ----------------------------------------------------------------------


class PottsCompatibility:
    """out = -w * Q (labelcompatibility.cpp:46-48)."""

    def __init__(self, weight: float):
        self.weight = float(weight)

    def apply(self, q: jnp.ndarray) -> jnp.ndarray:
        return -self.weight * q

    apply_transpose = apply


class DiagonalCompatibility:
    """out = diag(v) @ Q (labelcompatibility.cpp:66-69)."""

    def __init__(self, v: Sequence[float]):
        self.v = jnp.asarray(np.asarray(v, dtype=np.float32))

    def apply(self, q: jnp.ndarray) -> jnp.ndarray:
        return q * self.v[None, :]

    apply_transpose = apply


class MatrixCompatibility:
    """out = M @ Q with M symmetrized (labelcompatibility.cpp:79-87)."""

    def __init__(self, m: np.ndarray):
        m = np.asarray(m, dtype=np.float32)
        self.m = jnp.asarray(0.5 * (m + m.T))

    # HIGHEST: a float32 product on the GPU may otherwise run in TF32.
    def apply(self, q: jnp.ndarray) -> jnp.ndarray:
        return jnp.matmul(q, self.m.T, precision=jax.lax.Precision.HIGHEST)

    def apply_transpose(self, q: jnp.ndarray) -> jnp.ndarray:
        return jnp.matmul(q, self.m, precision=jax.lax.Precision.HIGHEST)


Compatibility = Union[PottsCompatibility, DiagonalCompatibility, MatrixCompatibility]


# ----------------------------------------------------------------------
# Pairwise potential = normalization o lattice filter o compatibility
# ----------------------------------------------------------------------


@dataclass
class PairwisePotential:
    lattice: PermutohedralLattice
    compatibility: Compatibility
    ntype: NormalizationType
    # Device copies of the lattice tensors.
    offsets: jnp.ndarray = None
    barycentric: jnp.ndarray = None
    blur_n1: jnp.ndarray = None
    blur_n2: jnp.ndarray = None
    # Lazy [N] normalization vector (already inverted): the eager step
    # path and tests materialize it on first access; the fused inference
    # recomputes the same formula in-dispatch so potential BUILD does no
    # device work at all (the eager filter-of-ones is a few dozen
    # dispatches per potential).
    _norm_cache: Optional[jnp.ndarray] = None

    @classmethod
    def build(
        cls,
        features: np.ndarray,  # [N, d]
        compatibility: Compatibility,
        ntype: NormalizationType = NormalizationType.NORMALIZE_SYMMETRIC,
    ) -> "PairwisePotential":
        lattice = build_lattice(features)
        return cls(
            lattice=lattice,
            compatibility=compatibility,
            ntype=ntype,
            offsets=jnp.asarray(lattice.offsets),
            barycentric=jnp.asarray(lattice.barycentric),
            blur_n1=jnp.asarray(lattice.blur_n1),
            blur_n2=jnp.asarray(lattice.blur_n2),
        )

    def _norm_from_raw(self, raw: jnp.ndarray) -> jnp.ndarray:
        """pairwise.cpp:46-61 (raw = lattice filter of all-ones)."""
        n = raw.shape[0]
        if self.ntype == NormalizationType.NO_NORMALIZATION:
            return jnp.full((n,), n / jnp.sum(raw))
        if self.ntype == NormalizationType.NORMALIZE_SYMMETRIC:
            return 1.0 / jnp.sqrt(raw + 1e-20)
        return 1.0 / (raw + 1e-20)

    @property
    def norm(self) -> jnp.ndarray:
        if self._norm_cache is None:
            n = self.offsets.shape[0]
            raw = lattice_filter(
                jnp.ones((n, 1), jnp.float32),
                self.offsets,
                self.barycentric,
                self.blur_n1,
                self.blur_n2,
                self.lattice.num_vertices,
            )[:, 0]
            self._norm_cache = self._norm_from_raw(raw)
        return self._norm_cache

    def _pre_post(self, transpose: bool = False) -> Tuple[bool, bool]:
        """Which side(s) of the filter the normalization rides (pairwise.cpp:63-80)."""
        nt = self.ntype
        pre = (
            nt == NormalizationType.NORMALIZE_SYMMETRIC
            or (nt == NormalizationType.NORMALIZE_BEFORE and not transpose)
            or (nt == NormalizationType.NORMALIZE_AFTER and transpose)
        )
        post = (
            nt == NormalizationType.NORMALIZE_SYMMETRIC
            or (nt == NormalizationType.NORMALIZE_BEFORE and transpose)
            or (nt == NormalizationType.NORMALIZE_AFTER and not transpose)
        )
        return pre, post

    def _filter(self, q: jnp.ndarray, transpose: bool) -> jnp.ndarray:
        """pairwise.cpp:63-80."""
        pre, post = self._pre_post(transpose)
        out = q * self.norm[:, None] if pre else q
        out = lattice_filter(
            out,
            self.offsets,
            self.barycentric,
            self.blur_n1,
            self.blur_n2,
            self.lattice.num_vertices,
            reverse=transpose,
        )
        if post:
            out = out * self.norm[:, None]
        return out

    def apply(self, q: jnp.ndarray) -> jnp.ndarray:
        """kernel then compatibility (pairwise.cpp:173-178)."""
        return self.compatibility.apply(self._filter(q, transpose=False))

    def apply_transpose(self, q: jnp.ndarray) -> jnp.ndarray:
        return self.compatibility.apply_transpose(self._filter(q, transpose=True))


# ----------------------------------------------------------------------
# DenseCRF
# ----------------------------------------------------------------------


def _norm_from_raw_static(raw: jnp.ndarray, flag_pair: Tuple[bool, bool]) -> jnp.ndarray:
    """Normalization vector from the all-ones filter (pairwise.cpp:46-61).

    The (pre, post) application flags identify the mode uniquely at
    transpose=False: (True, True) = SYMMETRIC, exactly one = BEFORE/AFTER
    (same inverse formula), (False, False) = NO_NORMALIZATION (vector
    unused by the filter; the global-scale formula kept for completeness).
    """
    pre, post = flag_pair
    if pre and post:
        return 1.0 / jnp.sqrt(raw + 1e-20)
    if pre or post:
        return 1.0 / (raw + 1e-20)
    n = raw.shape[0]
    return jnp.full((n,), n / jnp.sum(raw))


@partial(
    jax.jit,
    static_argnames=("n_iterations", "flags", "ms", "return_map", "num_labels"),
)
def _fused_potts_inference(
    unary: jnp.ndarray,  # [N, C] energies, OR [N] int labels (num_labels set)
    weights: jnp.ndarray,  # [K] Potts weights
    norms: Tuple[jnp.ndarray, ...],  # K x [N], OR () to compute in-dispatch
    latts: Tuple[Tuple[jnp.ndarray, ...], ...],  # K x (offsets, bary, n1, n2)
    n_iterations: int,
    flags: Tuple[Tuple[bool, bool], ...],  # K x (pre, post) normalization
    ms: Tuple[int, ...],  # K x num_vertices (static: shapes the splat)
    return_map: bool = False,
    num_labels: int = 0,
    label_energies: Optional[jnp.ndarray] = None,  # [3] (u, n, p) energies
) -> jnp.ndarray:
    """The whole mean-field loop (densecrf.cpp:115-131) as ONE dispatch.

    ``DenseCRF.step_inference`` runs eagerly — every jnp op inside
    ``lattice_filter`` is its own device dispatch, so a 5-iteration
    2-kernel demo pays hundreds of dispatches. Fusing the loop under one
    jit with ``lax.fori_loop`` makes it a single dispatch. The op sequence per iteration is IDENTICAL to the
    step path (same filters, same normalization sides, same softmax), so
    results match the step loop bit-for-bit up to XLA fusion.

    Transfer-thrift extras (host->device payload is part of the span):

    - ``norms=()`` recomputes each potential's normalization vector
      (filter of all-ones, pairwise.cpp:46-61) inside the dispatch
      instead of shipping K x [N] f32 vectors built eagerly.
    - ``num_labels=C`` + ``label_energies=(u, n, p)`` treats ``unary`` as
      an [N] int label map and builds the [N, C] unary energies on device
      (dense_inference.cpp:37-52: unknown -> u everywhere; known -> n
      everywhere, p at the label) — a [N] int8 upload instead of [N, C]
      f32 (6.5 MB -> 77 KB at the demo's 76.8k x 21).
    - ``return_map=True`` folds the MAP argmax (densecrf.cpp:202-211)
      into the same dispatch — ``jnp.argmax`` picks the first maximum,
      matching the reference's strict-> scan.
    """
    if num_labels:
        labels = unary.astype(jnp.int32)  # [N]
        u_e, n_e, p_e = (label_energies[i] for i in range(3))
        known = labels >= 0
        base = jnp.where(known, n_e, u_e)[:, None]  # [N, 1]
        onehot = labels[:, None] == jnp.arange(num_labels, dtype=jnp.int32)
        unary = jnp.where(onehot, p_e, base)
    if not norms:
        norms = tuple(
            _norm_from_raw_static(
                lattice_filter(
                    jnp.ones((unary.shape[0], 1), jnp.float32), *latts[k], ms[k]
                )[:, 0],
                flags[k],
            )
            for k in range(len(latts))
        )
    q0 = exp_and_normalize(-unary)

    def body(_, q):
        tmp = -unary
        for k in range(len(latts)):
            pre, post = flags[k]
            out = q * norms[k][:, None] if pre else q
            out = lattice_filter(out, *latts[k], ms[k])
            if post:
                out = out * norms[k][:, None]
            # Potts apply is -w*out; the step subtracts it (densecrf.cpp:121).
            tmp = tmp + weights[k] * out
        return exp_and_normalize(tmp)

    q = jax.lax.fori_loop(0, n_iterations, body, q0)
    if return_map:
        return jnp.argmax(q, axis=1).astype(jnp.int32)
    return q


def exp_and_normalize(x: jnp.ndarray) -> jnp.ndarray:
    """Column softmax with max subtraction (densecrf.cpp:98-106), [N, C]."""
    x = x - jnp.max(x, axis=1, keepdims=True)
    e = jnp.exp(x)
    return e / jnp.sum(e, axis=1, keepdims=True)


class DenseCRF:
    """Fully-connected CRF over N variables with C labels."""

    def __init__(self, n: int, num_labels: int):
        self.n = int(n)
        self.num_labels = int(num_labels)
        self.unary: Optional[jnp.ndarray] = None  # [N, C]
        self.pairwise: List[PairwisePotential] = []

    # -- energies ------------------------------------------------------
    def set_unary_energy(self, unary: np.ndarray) -> None:
        """Constant unary energy [N, C] (unary.cpp ConstUnaryEnergy)."""
        unary = jnp.asarray(unary, dtype=jnp.float32)
        assert unary.shape == (self.n, self.num_labels)
        self.unary = unary

    def add_pairwise_energy(
        self,
        features: np.ndarray,  # [N, d]
        compatibility: Compatibility,
        ntype: NormalizationType = NormalizationType.NORMALIZE_SYMMETRIC,
    ) -> None:
        assert features.shape[0] == self.n
        self.pairwise.append(PairwisePotential.build(features, compatibility, ntype))

    # -- inference (densecrf.cpp:115-131) -------------------------------
    def start_inference(self) -> jnp.ndarray:
        unary = self.unary if self.unary is not None else jnp.zeros((self.n, self.num_labels))
        return exp_and_normalize(-unary)

    def step_inference(self, q: jnp.ndarray) -> jnp.ndarray:
        tmp1 = -self.unary if self.unary is not None else jnp.zeros_like(q)
        for pw in self.pairwise:
            tmp1 = tmp1 - pw.apply(q)
        return exp_and_normalize(tmp1)

    def inference(self, n_iterations: int, fused: Optional[bool] = None) -> jnp.ndarray:
        """Mean-field marginals after ``n_iterations`` (densecrf.cpp:115-131).

        ``fused=None`` auto-selects: all-Potts potentials run the whole
        loop as one jitted dispatch (:func:`_fused_potts_inference`; the
        eager step loop costs one dispatch PER OP); anything else falls
        back to the readable step loop.
        """
        if fused is None:
            fused = self._can_fuse()
        if not fused:
            q = self.start_inference()
            for _ in range(n_iterations):
                q = self.step_inference(q)
            return q
        unary = (
            self.unary
            if self.unary is not None
            else jnp.zeros((self.n, self.num_labels), jnp.float32)
        )
        return _fused_potts_inference(
            unary, *self._fused_args(), n_iterations=n_iterations,
            **self._fused_statics(),
        )

    def _can_fuse(self) -> bool:
        return bool(self.pairwise) and all(
            isinstance(pw.compatibility, PottsCompatibility)
            for pw in self.pairwise
        )

    def _fused_args(self):
        # norms=(): the normalization vectors are recomputed inside the
        # dispatch (transfer + eager-build thrift; see _fused_potts_inference).
        return (
            jnp.asarray(
                [pw.compatibility.weight for pw in self.pairwise], jnp.float32
            ),
            (),
            tuple(
                (pw.offsets, pw.barycentric, pw.blur_n1, pw.blur_n2)
                for pw in self.pairwise
            ),
        )

    def _fused_statics(self):
        return dict(
            flags=tuple(pw._pre_post() for pw in self.pairwise),
            ms=tuple(pw.lattice.num_vertices for pw in self.pairwise),
        )

    def map_from_labels(
        self,
        labels: np.ndarray,  # [N] int, -1 = unknown
        energies: Tuple[float, float, float],  # (u, n, p) energies
        n_iterations: int,
    ) -> np.ndarray:
        """MAP labels with the unary BUILT ON DEVICE from a label map.

        dense_inference.cpp:37-52 semantics: unknown points get the
        uniform energy ``u`` for every class; known points get ``n``
        everywhere and ``p`` at their label. Uploading the [N] int8 label
        map instead of the [N, C] f32 energies cuts the demo's dominant
        host->device transfer ~85x (6.5 MB -> 77 KB at 76.8k x 21).
        Requires all-Potts potentials.
        """
        if not self._can_fuse():
            raise ValueError("map_from_labels requires all-Potts potentials")
        labels = np.asarray(labels)
        dtype = np.int8 if self.num_labels < 128 else np.int32
        return np.asarray(
            _fused_potts_inference(
                jnp.asarray(labels.astype(dtype)),
                *self._fused_args(),
                n_iterations=n_iterations,
                **self._fused_statics(),
                return_map=True,
                num_labels=self.num_labels,
                label_energies=jnp.asarray(
                    np.asarray(energies, np.float32)
                ),
            )
        )

    def map(self, n_iterations: int) -> np.ndarray:
        """Per-point MAP labels (densecrf.cpp:132-137, 202-211).

        On the fused path the argmax rides the same dispatch as the
        mean-field loop (one device round trip for the whole call).
        """
        if self._can_fuse():
            unary = (
                self.unary
                if self.unary is not None
                else jnp.zeros((self.n, self.num_labels), jnp.float32)
            )
            return np.asarray(_fused_potts_inference(
                unary, *self._fused_args(), n_iterations=n_iterations,
                **self._fused_statics(), return_map=True,
            ))
        q = self.inference(n_iterations)
        return np.asarray(jnp.argmax(q, axis=1).astype(jnp.int32))

    # -- diagnostics -----------------------------------------------------
    def kl_divergence(self, q: jnp.ndarray) -> float:
        """densecrf.cpp:214-235."""
        kl = jnp.sum(q * jnp.log(jnp.maximum(q, 1e-20)))
        if self.unary is not None:
            kl = kl + jnp.sum(self.unary * q)
        for pw in self.pairwise:
            kl = kl + jnp.sum(q * pw.apply(q))
        return float(kl)


class DenseCRF2D(DenseCRF):
    """Image CRF with grid Gaussian and bilateral feature builders."""

    def __init__(self, w: int, h: int, num_labels: int):
        super().__init__(w * h, num_labels)
        self.w = int(w)
        self.h = int(h)

    def add_pairwise_gaussian(
        self,
        sx: float,
        sy: float,
        compatibility: Compatibility,
        ntype: NormalizationType = NormalizationType.NORMALIZE_SYMMETRIC,
    ) -> None:
        """densecrf.cpp:61-69."""
        xs, ys = np.meshgrid(np.arange(self.w), np.arange(self.h))
        feats = np.stack([xs.ravel() / sx, ys.ravel() / sy], axis=1)
        self.add_pairwise_energy(feats.astype(np.float32), compatibility, ntype)

    def add_pairwise_bilateral(
        self,
        sx: float,
        sy: float,
        sr: float,
        sg: float,
        sb: float,
        rgb: np.ndarray,  # [H, W, 3] uint8
        compatibility: Compatibility,
        ntype: NormalizationType = NormalizationType.NORMALIZE_SYMMETRIC,
    ) -> None:
        """densecrf.cpp:70-81."""
        xs, ys = np.meshgrid(np.arange(self.w), np.arange(self.h))
        c = rgb.reshape(-1, 3).astype(np.float32)
        feats = np.stack(
            [
                xs.ravel() / sx,
                ys.ravel() / sy,
                c[:, 0] / sr,
                c[:, 1] / sg,
                c[:, 2] / sb,
            ],
            axis=1,
        )
        self.add_pairwise_energy(feats.astype(np.float32), compatibility, ntype)


# ----------------------------------------------------------------------
# Fully-jitted mean-field for the map-fusion path (single Potts potential
# over [xyz*wxyz ; rgb*wrgb] features — segmenter.cpp:628-658)
# ----------------------------------------------------------------------


@partial(jax.jit, static_argnames=("num_vertices", "n_iterations"))
def potts_mean_field(
    unary: jnp.ndarray,  # [N, C] (the CRF energy, i.e. -accumulated unaries)
    offsets: jnp.ndarray,
    barycentric: jnp.ndarray,
    blur_n1: jnp.ndarray,
    blur_n2: jnp.ndarray,
    norm: jnp.ndarray,  # [N] symmetric-normalization vector
    weight: jnp.ndarray,  # Potts weight
    num_vertices: int,
    n_iterations: int,
) -> jnp.ndarray:
    """10x default mean-field with one symmetric-normalized Potts kernel."""

    def step(q, _):
        filtered = (
            lattice_filter(
                q * norm[:, None],
                offsets,
                barycentric,
                blur_n1,
                blur_n2,
                num_vertices,
            )
            * norm[:, None]
        )
        q_new = exp_and_normalize(-unary + weight * filtered)
        return q_new, None

    q0 = exp_and_normalize(-unary)
    q, _ = jax.lax.scan(step, q0, None, length=n_iterations)
    return q


@partial(jax.jit, static_argnames=("blocks", "num_vertices", "n_iterations"))
def potts_mean_field_multi_t(
    unary_t: jnp.ndarray,  # [sum(blocks), N] energies, layers stacked
    sorted_points: jnp.ndarray,
    sorted_weights: jnp.ndarray,
    seg_starts: jnp.ndarray,
    seg_ends: jnp.ndarray,
    offsets_t: jnp.ndarray,
    barycentric_t: jnp.ndarray,
    blur_n1: jnp.ndarray,
    blur_n2: jnp.ndarray,
    norm: jnp.ndarray,  # [N] symmetric-normalization vector
    weight: jnp.ndarray,
    blocks: Tuple[int, ...],
    num_vertices: int,
    n_iterations: int,
) -> jnp.ndarray:
    """Transposed-layout fused mean-field (the serving hot path).

    Same math as :func:`potts_mean_field_multi` in the [C, N] layout using
    :func:`lattice_filter_t` — every op keeps N as the minor axis, and the splat
    runs as a sorted segment sum instead of a scatter (see lattice.py).
    Differs from the per-layer reference run only in f32 summation order
    inside the splat.
    """
    from .lattice import lattice_filter_t

    def normalize_blocks(x):
        parts = []
        start = 0
        for c in blocks:
            b = x[start : start + c]
            b = b - jnp.max(b, axis=0, keepdims=True)
            e = jnp.exp(b)
            parts.append(e / jnp.sum(e, axis=0, keepdims=True))
            start += c
        return jnp.concatenate(parts, axis=0)

    def step(q, _):
        filtered = (
            lattice_filter_t(
                q * norm[None, :],
                sorted_points, sorted_weights, seg_starts, seg_ends,
                offsets_t, barycentric_t, blur_n1, blur_n2, num_vertices,
            )
            * norm[None, :]
        )
        return normalize_blocks(-unary_t + weight * filtered), None

    q0 = normalize_blocks(-unary_t)
    q, _ = jax.lax.scan(step, q0, None, length=n_iterations)
    return q


@partial(jax.jit, static_argnames=("blocks", "num_vertices", "n_iterations"))
def potts_mean_field_multi(
    unary: jnp.ndarray,  # [N, sum(blocks)] energies, layers concatenated
    offsets: jnp.ndarray,
    barycentric: jnp.ndarray,
    blur_n1: jnp.ndarray,
    blur_n2: jnp.ndarray,
    norm: jnp.ndarray,
    weight: jnp.ndarray,
    blocks: Tuple[int, ...],  # per-layer class counts
    num_vertices: int,
    n_iterations: int,
) -> jnp.ndarray:
    """Mean-field for SEVERAL independent Potts CRFs sharing one lattice.

    The reference runs one CRF per label layer over the same features
    (segmenter.cpp:638-644); the filter is channel-independent and its
    gathers and sums are per row, so running all layers' channels through
    ONE splat/blur/slice does the row work once for every layer. The softmax normalizes within each layer's block,
    which keeps every layer's iteration bit-identical to its standalone
    :func:`potts_mean_field` run.
    """

    def normalize_blocks(x):
        parts = []
        start = 0
        for c in blocks:
            parts.append(exp_and_normalize(x[:, start : start + c]))
            start += c
        return jnp.concatenate(parts, axis=1)

    def step(q, _):
        filtered = (
            lattice_filter(
                q * norm[:, None], offsets, barycentric, blur_n1, blur_n2,
                num_vertices,
            )
            * norm[:, None]
        )
        return normalize_blocks(-unary + weight * filtered), None

    q0 = normalize_blocks(-unary)
    q, _ = jax.lax.scan(step, q0, None, length=n_iterations)
    return q

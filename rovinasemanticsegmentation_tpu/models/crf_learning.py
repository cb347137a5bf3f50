"""CRF parameter learning: objectives, logistic unary, L-BFGS driver.

Capability parity with the densecrf learning stack
(``/root/reference/third-party/densecrf/src/objective.cpp:27-109``,
``src/unary.cpp:27-68``, ``src/optimization.cpp:27-135``), re-designed for
JAX: the reference hand-derives gradients through mean-field
(``densecrf.cpp:238-297``) and the permutohedral filter
(``permutohedral.cpp:612-695``); here the mean-field iterations are unrolled
and differentiated with ``jax.grad`` — the lattice filter is linear in its
values, so autodiff produces the exact transpose filtering the reference
implements by hand. The lattice *structure* (vertex geometry) is treated as
fixed per evaluation, as in the reference's DIAG/FULL kernel learning where
the lattice is rebuilt after each parameter step (pairwise.cpp:140-151).

Objectives evaluate over marginals ``Q [N, C]`` and ground truth ``gt [N]``
(labels < 0 ignored) and return the scalar the reference's ``evaluate``
returns (objectives are maximized):

- :func:`log_likelihood`: mean log Q[gt] with a robustness epsilon
  (objective.cpp:37-50);
- :func:`hamming`: class-weighted expected accuracy with the
  ``class_weight_pow`` reweighting (objective.cpp:51-80);
- :func:`intersection_over_union`: soft IoU over marginals
  (objective.cpp:81-109).

Numeric-gradient checking mirrors ``optimization.cpp`` (the reference's only
unit-test style) and is used by the tests.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np

from .crf import exp_and_normalize
from .lattice import PermutohedralLattice, build_lattice, lattice_filter


# ----------------------------------------------------------------------
# Objectives (maximized)
# ----------------------------------------------------------------------


def log_likelihood(q: jnp.ndarray, gt: jnp.ndarray, robust: float = 0.0) -> jnp.ndarray:
    """objective.cpp:37-50: mean over labeled points of log(Q[gt] + robust)."""
    n, c = q.shape
    valid = (gt >= 0) & (gt < c)
    safe_gt = jnp.clip(gt, 0, c - 1)
    qq = jnp.maximum(jnp.take_along_axis(q, safe_gt[:, None], axis=1)[:, 0] + robust, 1e-20)
    return jnp.sum(jnp.where(valid, jnp.log(qq), 0.0)) / n


def hamming_class_weights(gt: np.ndarray, num_classes: int, class_weight_pow: float) -> np.ndarray:
    """objective.cpp:51-64: w_c ∝ freq_c^-pow, normalized by sum cnt*w = 1."""
    cnt = np.bincount(gt[gt >= 0], minlength=num_classes).astype(np.float64)
    w = cnt / cnt.sum()
    with np.errstate(divide="ignore"):
        w = np.where(w > 0, w ** (-class_weight_pow), 0.0)
    return (w / (cnt * w).sum()).astype(np.float32)


def hamming(q: jnp.ndarray, gt: jnp.ndarray, class_weights: jnp.ndarray) -> jnp.ndarray:
    """objective.cpp:66-80: sum of w[gt] * Q[gt]."""
    n, c = q.shape
    valid = (gt >= 0) & (gt < c)
    safe_gt = jnp.clip(gt, 0, c - 1)
    qq = jnp.take_along_axis(q, safe_gt[:, None], axis=1)[:, 0]
    return jnp.sum(jnp.where(valid, jnp.take(class_weights, safe_gt) * qq, 0.0))


def intersection_over_union(q: jnp.ndarray, gt: jnp.ndarray) -> jnp.ndarray:
    """objective.cpp:81-109: mean over classes of soft I/U over marginals."""
    n, c = q.shape
    valid = (gt >= 0) & (gt < c)
    safe_gt = jnp.clip(gt, 0, c - 1)
    onehot = jax.nn.one_hot(safe_gt, c) * valid[:, None]
    intersection = jnp.sum(onehot * q, axis=0)  # [C]
    # Union: gt count of the class + sum of Q over other-class points.
    union = (
        1e-20
        + jnp.sum(onehot, axis=0)
        + jnp.sum(q * valid[:, None] * (1.0 - onehot), axis=0)
    )
    return jnp.sum(intersection / union) / c


# ----------------------------------------------------------------------
# Unary energies (unary.cpp:27-68)
# ----------------------------------------------------------------------


class ConstUnaryEnergy:
    def __init__(self, unary: np.ndarray):  # [N, C]
        self.unary = jnp.asarray(unary, jnp.float32)

    def get(self, params=None) -> jnp.ndarray:
        return self.unary

    def init_params(self):
        return None


class LogisticUnaryEnergy:
    """U = L @ f with trainable L (unary.cpp:45-68), layout [N, C] here."""

    def __init__(self, l_matrix: np.ndarray, f: np.ndarray):
        # Reference: L [C, F], f [F, N]; ours: features [N, F].
        self.features = jnp.asarray(f, jnp.float32)
        self._l0 = jnp.asarray(l_matrix, jnp.float32)

    def get(self, params: Optional[jnp.ndarray] = None) -> jnp.ndarray:
        l = self._l0 if params is None else params
        return jnp.matmul(  # [N, C]; HIGHEST keeps float32 off TF32
            self.features, l.T, precision=jax.lax.Precision.HIGHEST
        )

    def init_params(self) -> jnp.ndarray:
        return self._l0


# ----------------------------------------------------------------------
# Differentiable mean-field + learner
# ----------------------------------------------------------------------


@dataclass
class LearnablePotts:
    """One lattice-filtered Potts potential with a trainable weight."""

    lattice: PermutohedralLattice
    offsets: jnp.ndarray
    barycentric: jnp.ndarray
    blur_n1: jnp.ndarray
    blur_n2: jnp.ndarray
    norm: jnp.ndarray

    @classmethod
    def build(cls, features: np.ndarray) -> "LearnablePotts":
        lattice = build_lattice(features)
        offsets = jnp.asarray(lattice.offsets)
        bary = jnp.asarray(lattice.barycentric)
        n1 = jnp.asarray(lattice.blur_n1)
        n2 = jnp.asarray(lattice.blur_n2)
        ones = jnp.ones((features.shape[0], 1), jnp.float32)
        raw = lattice_filter(ones, offsets, bary, n1, n2, lattice.num_vertices)[:, 0]
        norm = 1.0 / jnp.sqrt(raw + 1e-20)
        return cls(lattice, offsets, bary, n1, n2, norm)

    def filter(self, q: jnp.ndarray) -> jnp.ndarray:
        return (
            lattice_filter(
                q * self.norm[:, None],
                self.offsets,
                self.barycentric,
                self.blur_n1,
                self.blur_n2,
                self.lattice.num_vertices,
            )
            * self.norm[:, None]
        )


def mean_field_marginals(
    unary: jnp.ndarray,  # [N, C] energy
    potentials: Sequence[LearnablePotts],
    weights: Sequence[jnp.ndarray],  # Potts weight per potential
    n_iterations: int,
) -> jnp.ndarray:
    """Unrolled, differentiable mean-field (densecrf.cpp:115-131)."""
    q = exp_and_normalize(-unary)
    for _ in range(n_iterations):
        t = -unary
        for pot, w in zip(potentials, weights):
            t = t + w * pot.filter(q)  # Potts: compat = -w * filtered
        q = exp_and_normalize(t)
    return q


class CrfLearner:
    """Fit Potts weights (and optionally a logistic unary) to ground truth.

    Replaces the reference's hand-rolled gradient machinery + liblbfgs
    (densecrf.cpp:238-360, optimization.cpp:27-135) with jax.grad through the
    unrolled mean-field and an L-BFGS driver.
    """

    def __init__(
        self,
        unary_energy,
        potentials: Sequence[LearnablePotts],
        gt: np.ndarray,
        n_iterations: int = 5,
        objective: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray] = log_likelihood,
    ):
        self.unary_energy = unary_energy
        self.potentials = list(potentials)
        self.gt = jnp.asarray(gt.astype(np.int32))
        self.n_iterations = n_iterations
        self.objective = objective

        def neg_objective(params):
            unary = self.unary_energy.get(params.get("unary"))
            q = mean_field_marginals(
                unary, self.potentials, params["weights"], self.n_iterations
            )
            return -self.objective(q, self.gt)

        self._value_and_grad = jax.jit(jax.value_and_grad(neg_objective))

    def init_params(self, initial_weights: Sequence[float]) -> Dict:
        params = {"weights": [jnp.float32(w) for w in initial_weights]}
        unary_params = self.unary_energy.init_params()
        if unary_params is not None:
            params["unary"] = unary_params
        else:
            params["unary"] = None
        return params

    def fit(
        self, initial_weights: Sequence[float], max_iter: int = 50
    ) -> Tuple[Dict, float]:
        """L-BFGS-B over flattened params; returns (params, objective)."""
        from scipy.optimize import minimize

        params0 = self.init_params(initial_weights)
        flat0, unravel = jax.flatten_util.ravel_pytree(params0)

        def fun(x):
            v, g = self._value_and_grad(unravel(jnp.asarray(x, jnp.float32)))
            gflat, _ = jax.flatten_util.ravel_pytree(g)
            return float(v), np.asarray(gflat, np.float64)

        res = minimize(
            fun, np.asarray(flat0, np.float64), jac=True, method="L-BFGS-B",
            options={"maxiter": max_iter},
        )
        return unravel(jnp.asarray(res.x, jnp.float32)), -float(res.fun)


class _KernelCrfLearner:
    """Learn kernel feature-transform parameters of a Potts kernel.

    Mirrors the reference's kernel-parameter learning
    (``pairwise.cpp:116-163``): the lattice is re-initialized from the
    transformed features after every parameter step (:140-151), and the
    gradient w.r.t. the parameters flows through the filter's barycentric
    weights — here via :func:`lattice_filter_differentiable` and jax.grad
    instead of the hand-derived ``featureGradient`` (:87-114). Subclasses
    provide ``_transform(base, params) -> feats`` for the DIAG
    (per-dimension scales, pairwise.cpp:208-230) and FULL (dense d x d
    matrix, pairwise.cpp:232-254) kernel types.
    """

    def __init__(
        self,
        unary: np.ndarray,  # [N, C] energies
        base_features: np.ndarray,  # [N, d] unscaled kernel features
        gt: np.ndarray,  # [N]
        n_iterations: int = 3,
        objective: Callable[[jnp.ndarray, jnp.ndarray], jnp.ndarray] = log_likelihood,
        extra_potentials: Sequence[LearnablePotts] = (),
        extra_weights: Sequence[float] = (),
    ):
        """``extra_potentials``/``extra_weights``: additional FIXED Potts
        terms active in the mean-field while the kernel potential's
        parameters are learned (dense_learning.cpp keeps the grid Gaussian
        in the model during its kernel phase)."""
        self.unary = jnp.asarray(unary, jnp.float32)
        self.base = np.asarray(base_features, np.float32)
        self.gt = jnp.asarray(gt.astype(np.int32))
        self.n_iterations = n_iterations
        self.objective = objective
        self.extra = list(zip(extra_potentials, [float(w) for w in extra_weights]))

    @staticmethod
    def _transform(base: jnp.ndarray, params: jnp.ndarray) -> jnp.ndarray:
        raise NotImplementedError

    def _neg_obj_and_grad(
        self, weight: float, params: np.ndarray, lattice_at: np.ndarray = None
    ):
        """Value and gradient at ``params``.

        The lattice structure is built from ``lattice_at`` (defaults to
        ``params``) — pass the unperturbed parameters to evaluate with a
        FIXED lattice, which is the analytic gradient's own semantics
        (pairwise.cpp re-inits the lattice only between optimizer steps).
        """
        from .lattice import build_lattice, differentiable_barycentric

        params = np.asarray(params, np.float32)
        at = params if lattice_at is None else np.asarray(lattice_at, np.float32)
        feats = np.asarray(self._transform(jnp.asarray(self.base), at))
        if not np.isfinite(feats).all() or np.abs(feats).max() > 1e6:
            # A line-search step proposed degenerate kernel parameters; a
            # huge finite objective makes L-BFGS-B backtrack (inf/nan would
            # poison its quasi-Newton state; the reference's C++ would feed
            # garbage into the lattice here).
            return 1e10, 0.0, np.zeros(params.size, np.float64)
        lattice = build_lattice(feats, use_native=False)
        offsets = jnp.asarray(lattice.offsets)
        n1 = jnp.asarray(lattice.blur_n1)
        n2 = jnp.asarray(lattice.blur_n2)
        rem0 = jnp.asarray(lattice.rem0)
        rank = jnp.asarray(lattice.rank)
        m = lattice.num_vertices
        base = jnp.asarray(self.base)

        def neg_obj(w, p):
            f = self._transform(base, p)
            bary = differentiable_barycentric(f, rem0, rank)

            def filt(q):
                return lattice_filter(q, offsets, bary, n1, n2, m)

            raw = filt(jnp.ones((f.shape[0], 1)))[:, 0]
            norm = 1.0 / jnp.sqrt(raw + 1e-20)  # symmetric normalization

            q = exp_and_normalize(-self.unary)
            for _ in range(self.n_iterations):
                filtered = filt(q * norm[:, None]) * norm[:, None]
                t = -self.unary + w * filtered
                for pot, pw in self.extra:
                    t = t + pw * pot.filter(q)
                q = exp_and_normalize(t)
            return -self.objective(q, self.gt)

        v, (gw, gp) = jax.value_and_grad(neg_obj, argnums=(0, 1))(
            jnp.float32(weight), jnp.asarray(params)
        )
        return float(v), float(gw), np.asarray(gp, np.float64)

    def _fit_flat(
        self, initial_weight: float, params0: np.ndarray, max_iter: int
    ) -> Tuple[float, np.ndarray, float]:
        """L-BFGS over (weight, params); lattice rebuilt per evaluation."""
        from scipy.optimize import minimize

        shape = params0.shape

        def fun(x):
            if not np.isfinite(x).all():
                return 1e10, np.zeros(x.size)
            v, gw, gp = self._neg_obj_and_grad(x[0], x[1:].reshape(shape))
            g = np.concatenate([[gw], gp.ravel()])
            if not (np.isfinite(v) and np.isfinite(g).all()):
                # Degenerate evaluation (collapsed lattice, saturated
                # softmax): huge finite penalty so L-BFGS-B backtracks.
                return 1e10, np.zeros(x.size)
            return v, g

        x0 = np.concatenate([[initial_weight], params0.ravel().astype(np.float64)])
        res = minimize(fun, x0, jac=True, method="L-BFGS-B",
                       options={"maxiter": max_iter})
        return float(res.x[0]), res.x[1:].reshape(shape).copy(), -float(res.fun)


class DiagKernelCrfLearner(_KernelCrfLearner):
    """DIAG_KERNEL: per-dimension feature scales (pairwise.cpp:208-230)."""

    @staticmethod
    def _transform(base: jnp.ndarray, params: jnp.ndarray) -> jnp.ndarray:
        return base * params[None, :]

    def fit(
        self,
        initial_weight: float,
        initial_scales: Sequence[float],
        max_iter: int = 30,
    ) -> Tuple[float, np.ndarray, float]:
        return self._fit_flat(
            initial_weight, np.asarray(initial_scales, np.float64), max_iter
        )


class FullKernelCrfLearner(_KernelCrfLearner):
    """FULL_KERNEL: a dense d x d feature transform (pairwise.cpp:232-254).

    The reference parameterizes the kernel as features' = A @ features and
    learns every entry of A (its ``featureGradient`` contracts the filter
    gradient with the untransformed features, pairwise.cpp:246-252); here
    the same contraction falls out of jax.grad through the barycentric
    weights of ``f @ A.T``.
    """

    @staticmethod
    def _transform(base: jnp.ndarray, params: jnp.ndarray) -> jnp.ndarray:
        return jnp.matmul(
            base, params.T, precision=jax.lax.Precision.HIGHEST
        )

    def fit(
        self,
        initial_weight: float,
        initial_matrix: np.ndarray,  # [d, d]
        max_iter: int = 30,
    ) -> Tuple[float, np.ndarray, float]:
        m0 = np.asarray(initial_matrix, np.float64)
        if m0.ndim != 2 or m0.shape[0] != m0.shape[1]:
            raise ValueError("initial_matrix must be square [d, d]")
        return self._fit_flat(initial_weight, m0, max_iter)


def numeric_gradient(
    fn: Callable[[np.ndarray], float], x: np.ndarray, eps: float = 1e-3
) -> np.ndarray:
    """Central finite differences (optimization.cpp numeric gradient)."""
    x = np.asarray(x, np.float64)
    g = np.zeros_like(x)
    for i in range(x.size):
        xp, xm = x.copy(), x.copy()
        xp.flat[i] += eps
        xm.flat[i] -= eps
        g.flat[i] = (fn(xp) - fn(xm)) / (2 * eps)
    return g

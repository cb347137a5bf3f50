"""Permutohedral lattice + dense-CRF tests against a literal NumPy oracle.

The oracle re-implements permutohedral.cpp init (:323-474) and seqCompute
(:476-527) with plain Python loops and a dict hash table, mirroring the C++
statement by statement. The JAX lattice must match it to float tolerance
(vertex numbering differs; filter output must not).
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.models.crf import (
    DenseCRF,
    DenseCRF2D,
    DiagonalCompatibility,
    MatrixCompatibility,
    NormalizationType,
    PottsCompatibility,
    exp_and_normalize,
    potts_mean_field,
)
from rovinasemanticsegmentation_tpu.models.lattice import (
    build_lattice,
    filter_ones_norm,
    lattice_filter,
)


# ----------------------------------------------------------------------
# Oracle: literal port of the reference C++
# ----------------------------------------------------------------------


class OracleLattice:
    def __init__(self, features):  # features [N, d]
        f = np.asarray(features, dtype=np.float32)
        self.N, self.d = f.shape
        d = self.d
        hash_table = {}
        keys_in_order = []

        canonical = np.zeros((d + 1, d + 1), dtype=np.int16)
        for i in range(d + 1):
            for j in range(d + 1 - i):
                canonical[i, j] = i
            for j in range(d + 1 - i, d + 1):
                canonical[i, j] = i - (d + 1)

        inv_std_dev = np.sqrt(2.0 / 3.0) * (d + 1)
        scale_factor = np.array(
            [1.0 / np.sqrt((i + 2) * (i + 1)) * inv_std_dev for i in range(d)],
            dtype=np.float32,
        )

        self.offset = np.zeros((self.N, d + 1), dtype=np.int32)
        self.rank = np.zeros((self.N, d + 1), dtype=np.int16)
        self.barycentric = np.zeros((self.N, d + 1), dtype=np.float32)

        for k in range(self.N):
            elevated = np.zeros(d + 1, dtype=np.float64)
            sm = 0.0
            for j in range(d, 0, -1):
                cf = float(f[k, j - 1]) * float(scale_factor[j - 1])
                elevated[j] = sm - j * cf
                sm += cf
            elevated[0] = sm

            down_factor = 1.0 / (d + 1)
            up_factor = float(d + 1)
            rem0 = np.zeros(d + 1)
            _sum = 0
            for i in range(d + 1):
                v = down_factor * elevated[i]
                up = np.ceil(v) * up_factor
                down = np.floor(v) * up_factor
                rd2 = int(up) if up - elevated[i] < elevated[i] - down else int(down)
                rem0[i] = rd2
                _sum += int(rd2 * down_factor)

            rank = np.zeros(d + 1, dtype=np.int32)
            for i in range(d):
                di = elevated[i] - rem0[i]
                for j in range(i + 1, d + 1):
                    if di < elevated[j] - rem0[j]:
                        rank[i] += 1
                    else:
                        rank[j] += 1

            for i in range(d + 1):
                rank[i] += _sum
                if rank[i] < 0:
                    rank[i] += d + 1
                    rem0[i] += d + 1
                elif rank[i] > d:
                    rank[i] -= d + 1
                    rem0[i] -= d + 1

            bary = np.zeros(d + 2)
            for i in range(d + 1):
                v = (elevated[i] - rem0[i]) * down_factor
                bary[d - rank[i]] += v
                bary[d - rank[i] + 1] -= v
            bary[0] += 1.0 + bary[d + 1]

            for remainder in range(d + 1):
                key = tuple(
                    int(rem0[i]) + int(canonical[remainder, rank[i]])
                    for i in range(d)
                )
                if key not in hash_table:
                    hash_table[key] = len(hash_table)
                    keys_in_order.append(key)
                self.offset[k, remainder] = hash_table[key]
                self.rank[k, remainder] = rank[remainder]
                self.barycentric[k, remainder] = bary[remainder]

        self.M = len(hash_table)
        self.blur_n1 = np.zeros((d + 1, self.M), dtype=np.int32)
        self.blur_n2 = np.zeros((d + 1, self.M), dtype=np.int32)
        for j in range(d + 1):
            for i in range(self.M):
                key = keys_in_order[i]
                n1 = [key[kk] - 1 for kk in range(d)]
                n2 = [key[kk] + 1 for kk in range(d)]
                if j < d:
                    n1[j] = key[j] + d
                    n2[j] = key[j] - d
                self.blur_n1[j, i] = hash_table.get(tuple(n1), -1)
                self.blur_n2[j, i] = hash_table.get(tuple(n2), -1)

    def compute(self, inp, reverse=False):  # inp [N, C]
        N, d, M = self.N, self.d, self.M
        C = inp.shape[1]
        values = np.zeros((M + 2, C), dtype=np.float64)
        for i in range(N):
            for j in range(d + 1):
                o = self.offset[i, j] + 1
                w = self.barycentric[i, j]
                values[o] += w * inp[i]
        js = range(d, -1, -1) if reverse else range(d + 1)
        for j in js:
            new_values = np.zeros_like(values)
            for i in range(M):
                n1 = self.blur_n1[j, i] + 1
                n2 = self.blur_n2[j, i] + 1
                new_values[i + 1] = values[i + 1] + 0.5 * (values[n1] + values[n2])
            values = new_values
        alpha = 1.0 / (1 + 2.0 ** (-d))
        out = np.zeros((N, C), dtype=np.float64)
        for i in range(N):
            for j in range(d + 1):
                o = self.offset[i, j] + 1
                w = self.barycentric[i, j]
                out[i] += w * values[o] * alpha
        return out.astype(np.float32)


def _jax_filter(lattice, values, reverse=False):
    return np.asarray(
        lattice_filter(
            jnp.asarray(values),
            jnp.asarray(lattice.offsets),
            jnp.asarray(lattice.barycentric),
            jnp.asarray(lattice.blur_n1),
            jnp.asarray(lattice.blur_n2),
            lattice.num_vertices,
            reverse=reverse,
        )
    )


@pytest.fixture(scope="module", params=[2, 5])
def features(request):
    rng = np.random.default_rng(request.param)
    n, d = 60, request.param
    return (rng.normal(size=(n, d)) * 2.0).astype(np.float32)


class TestLattice:
    def test_build_matches_oracle(self, features):
        oracle = OracleLattice(features)
        lat = build_lattice(features)
        assert lat.num_vertices == oracle.M
        # Barycentric weights are vertex-order independent.
        np.testing.assert_allclose(
            lat.barycentric, oracle.barycentric, rtol=2e-4, atol=2e-4
        )

    def test_filter_matches_oracle(self, features):
        oracle = OracleLattice(features)
        lat = build_lattice(features)
        rng = np.random.default_rng(0)
        vals = rng.normal(size=(features.shape[0], 3)).astype(np.float32)
        want = oracle.compute(vals)
        got = _jax_filter(lat, vals)
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)

    def test_filter_reverse_matches_oracle(self, features):
        oracle = OracleLattice(features)
        lat = build_lattice(features)
        rng = np.random.default_rng(1)
        vals = rng.normal(size=(features.shape[0], 2)).astype(np.float32)
        np.testing.assert_allclose(
            _jax_filter(lat, vals, reverse=True),
            oracle.compute(vals, reverse=True),
            rtol=2e-3,
            atol=2e-3,
        )

    def test_transposed_filter_matches(self, features):
        """lattice_filter_t ([C, N] layout, sorted-segment splat) equals the
        points-major filter up to f32 summation order."""
        from rovinasemanticsegmentation_tpu.models.lattice import (
            attach_sorted_stream,
            lattice_filter_t,
            pad_lattice,
        )

        lat = attach_sorted_stream(pad_lattice(build_lattice(features), 64))
        rng = np.random.default_rng(2)
        vals = rng.normal(size=(features.shape[0], 3)).astype(np.float32)
        want = _jax_filter(lat, vals)
        for reverse in (False, True):
            got = np.asarray(
                lattice_filter_t(
                    jnp.asarray(vals.T),
                    jnp.asarray(lat.sorted_points),
                    jnp.asarray(lat.sorted_weights),
                    jnp.asarray(lat.seg_starts),
                    jnp.asarray(lat.seg_ends),
                    jnp.asarray(lat.offsets.T),
                    jnp.asarray(lat.barycentric.T),
                    jnp.asarray(lat.blur_n1),
                    jnp.asarray(lat.blur_n2),
                    lat.num_vertices,
                    reverse=reverse,
                )
            ).T
            want_r = _jax_filter(lat, vals, reverse=reverse)
            np.testing.assert_allclose(got, want_r, rtol=1e-4, atol=1e-5)

    def test_device_build_matches_host(self, features):
        """build_lattice_device == NumPy build + pad + sorted stream:
        same vertex numbering (both lexicographic), offsets, barycentric,
        blur tables, and filter output."""
        from rovinasemanticsegmentation_tpu.models.lattice import (
            attach_sorted_stream,
            build_lattice_device,
            lattice_filter_t,
            pad_lattice,
        )

        rng = np.random.default_rng(11)
        base = build_lattice(features, use_native=False)
        bucket = 1 << int(np.ceil(np.log2(base.num_vertices + 1)))
        host = attach_sorted_stream(pad_lattice(base, bucket))
        out = build_lattice_device(jnp.asarray(features), m_bucket=bucket)
        sp, sw, ss, se, ot, bt, b1, b2, m = out
        m = int(m)
        assert m == base.num_vertices
        np.testing.assert_array_equal(np.asarray(ot).T, host.offsets)
        np.testing.assert_allclose(
            np.asarray(bt).T, host.barycentric, rtol=1e-5, atol=1e-6
        )
        np.testing.assert_array_equal(np.asarray(b1)[:, :m], host.blur_n1[:, :m])
        np.testing.assert_array_equal(np.asarray(b2)[:, :m], host.blur_n2[:, :m])
        vals = rng.normal(size=(3, features.shape[0])).astype(np.float32)
        got = np.asarray(
            lattice_filter_t(jnp.asarray(vals), sp, sw, ss, se, ot, bt, b1, b2, bucket)
        )
        want = np.asarray(
            lattice_filter_t(
                jnp.asarray(vals),
                jnp.asarray(host.sorted_points),
                jnp.asarray(host.sorted_weights),
                jnp.asarray(host.seg_starts),
                jnp.asarray(host.seg_ends),
                jnp.asarray(host.offsets.T),
                jnp.asarray(host.barycentric.T),
                jnp.asarray(host.blur_n1),
                jnp.asarray(host.blur_n2),
                bucket,
            )
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    @pytest.mark.parametrize("scale,seed", [(1.0, 0), (0.05, 7)])
    def test_sort_neighbors_match_key_lookup(self, features, scale, seed):
        """_blur_neighbors_sort against a dictionary of the unique vertex
        keys: n1 along axis j is the key with coordinate j + d and every
        other coordinate - 1, n2 the opposite; absent keys are the missing
        slot. Sparse and duplicate-heavy point sets."""
        from rovinasemanticsegmentation_tpu.models.lattice import (
            _blur_neighbors_sort,
            _dedup_sorted,
            _embed_simplex,
            _pack_keys16,
        )

        rng = np.random.default_rng(seed)
        feats = rng.normal(size=features.shape).astype(np.float32) * scale
        n, d = feats.shape
        s = n * (d + 1)
        spad = -(-s // 128) * 128
        keys, bary = _embed_simplex(jnp.asarray(feats))
        kflat = keys.reshape(s, d)
        m_bucket = 1 << 12
        *_, m, uq, ucoord = _dedup_sorted(
            _pack_keys16(kflat, d), kflat, bary, n, d, m_bucket, spad
        )
        m = int(m)
        assert m <= m_bucket
        coords = np.stack([np.asarray(c)[:m] for c in ucoord], axis=1)
        slot = {tuple(k): i for i, k in enumerate(coords.tolist())}
        assert len(slot) == m
        n1, n2 = (np.asarray(a) for a in
                  _blur_neighbors_sort(uq, ucoord, m, m_bucket, d))
        for j in range(d + 1):
            step = np.full(d, -1)
            if j < d:
                step[j] = d
            for table, sign in ((n1, 1), (n2, -1)):
                want = [slot.get(tuple(k), m_bucket)
                        for k in (coords + sign * step).tolist()]
                np.testing.assert_array_equal(table[j, :m], want)
        assert (n1[:, m:] == m_bucket).all() and (n2[:, m:] == m_bucket).all()

    @pytest.mark.parametrize("c,s,m,seed", [
        (1, 300, 40, 0),      # one channel, segments with gaps and empties
        (17, 1000, 128, 1),   # the map path's 8 + 9 channels
        (3, 128, 1, 2),       # a single segment over the whole stream
    ])
    def test_segment_sum_sorted_matches_exact(self, c, s, m, seed):
        """segment_sum_sorted_t against a float64 per-segment sum, with
        empty segments (start == end) and rows no segment covers."""
        from rovinasemanticsegmentation_tpu.models.lattice import (
            segment_sum_sorted_t,
        )

        rng = np.random.default_rng(seed)
        x = rng.random((c, s)).astype(np.float32)
        cuts = np.sort(rng.integers(0, s + 1, size=2 * m))
        starts, ends = cuts[0::2], cuts[1::2]
        empty = rng.random(m) < 0.2
        starts[empty] = ends[empty]
        got = np.asarray(segment_sum_sorted_t(
            jnp.asarray(x), jnp.asarray(starts, jnp.int32),
            jnp.asarray(ends, jnp.int32)))
        want = np.stack([x[:, a:b].astype(np.float64).sum(axis=1)
                         for a, b in zip(starts, ends)], axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-3)

    def test_gaussian_behavior(self):
        # Identical features -> filter approximately sums everything
        # (the lattice's known self-weight deficit ~5% at d=3); far-apart
        # features -> approximately the value itself. Exactness is defined
        # by the oracle, which must agree to float precision.
        same = np.zeros((10, 3), dtype=np.float32)
        lat = build_lattice(same)
        ones = np.ones((10, 1), dtype=np.float32)
        out = _jax_filter(lat, ones)
        np.testing.assert_allclose(
            out, OracleLattice(same).compute(np.ones((10, 1))), rtol=1e-5
        )
        np.testing.assert_allclose(out, 10.0, rtol=0.1)

        far = (np.arange(5)[:, None] * 1000.0 * np.ones((1, 3))).astype(np.float32)
        lat2 = build_lattice(far)
        out2 = _jax_filter(lat2, np.ones((5, 1), dtype=np.float32))
        np.testing.assert_allclose(
            out2, OracleLattice(far).compute(np.ones((5, 1))), rtol=1e-3
        )
        assert (np.asarray(out2) < 1.0).all()  # no long-range coupling

    def test_norm_vector(self, features):
        lat = build_lattice(features)
        norm = filter_ones_norm(lat)
        assert norm.shape == (features.shape[0],)
        assert (norm > 0).all()


class TestDenseCRF:
    def _make_problem(self, n=80, c=4, seed=3):
        rng = np.random.default_rng(seed)
        unary = rng.normal(size=(n, c)).astype(np.float32)
        feats = rng.normal(size=(n, 3)).astype(np.float32)
        return unary, feats

    def test_softmax_matches_reference_form(self):
        x = np.array([[1.0, 2.0, 3.0], [0.0, 0.0, 0.0]], dtype=np.float32)
        q = np.asarray(exp_and_normalize(jnp.asarray(x)))
        e = np.exp(x - x.max(1, keepdims=True))
        np.testing.assert_allclose(q, e / e.sum(1, keepdims=True), rtol=1e-6)

    def test_inference_against_oracle(self):
        unary, feats = self._make_problem()
        oracle_lat = OracleLattice(feats)

        # Oracle mean-field with symmetric normalization + Potts(1.5).
        def oracle_inference(iters):
            norm_raw = oracle_lat.compute(np.ones((len(feats), 1)))[:, 0]
            norm = 1.0 / np.sqrt(norm_raw + 1e-20)
            q = np.exp(-(unary - unary.max(1, keepdims=True)))
            q /= q.sum(1, keepdims=True)
            for _ in range(iters):
                filtered = oracle_lat.compute(q * norm[:, None]) * norm[:, None]
                t = -unary - (-1.5 * filtered)
                t -= t.max(1, keepdims=True)
                q = np.exp(t)
                q /= q.sum(1, keepdims=True)
            return q

        crf = DenseCRF(len(feats), unary.shape[1])
        crf.set_unary_energy(unary)
        crf.add_pairwise_energy(feats, PottsCompatibility(1.5))
        got = np.asarray(crf.inference(5))
        want = oracle_inference(5)
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3)

    def test_potts_mean_field_matches_class(self):
        unary, feats = self._make_problem(seed=4)
        crf = DenseCRF(len(feats), unary.shape[1])
        crf.set_unary_energy(unary)
        crf.add_pairwise_energy(feats, PottsCompatibility(2.0))
        want = np.asarray(crf.inference(10))
        pw = crf.pairwise[0]
        got = np.asarray(
            potts_mean_field(
                jnp.asarray(unary),
                pw.offsets,
                pw.barycentric,
                pw.blur_n1,
                pw.blur_n2,
                pw.norm,
                jnp.float32(2.0),
                pw.lattice.num_vertices,
                10,
            )
        )
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)

    def test_smoothing_pulls_towards_neighbors(self):
        # Two spatial clusters with one dissenting point each: after CRF
        # smoothing the dissenter flips to its cluster's majority label.
        n = 20
        feats = np.zeros((n, 2), dtype=np.float32)
        feats[10:, 0] = 50.0
        unary = np.zeros((n, 2), dtype=np.float32)
        unary[:10, 0], unary[:10, 1] = -1.0, 1.0  # cluster A prefers label 0
        unary[10:, 0], unary[10:, 1] = 1.0, -1.0  # cluster B prefers label 1
        unary[0] = [1.0, -1.0]  # dissenter in A
        unary[10] = [-1.0, 1.0]  # dissenter in B
        crf = DenseCRF(n, 2)
        crf.set_unary_energy(unary)
        crf.add_pairwise_energy(feats, PottsCompatibility(4.0))
        labels = crf.map(10)
        assert (labels[:10] == 0).all()
        assert (labels[10:] == 1).all()

    def test_diagonal_and_matrix_compat(self):
        unary, feats = self._make_problem(n=30, c=3, seed=6)
        crf = DenseCRF(30, 3)
        crf.set_unary_energy(unary)
        crf.add_pairwise_energy(feats, DiagonalCompatibility([-1.0, -2.0, -0.5]))
        q1 = np.asarray(crf.inference(3))
        assert np.isfinite(q1).all()
        crf2 = DenseCRF(30, 3)
        crf2.set_unary_energy(unary)
        crf2.add_pairwise_energy(feats, MatrixCompatibility(-np.eye(3)))
        q2 = np.asarray(crf2.inference(3))
        assert np.isfinite(q2).all()
        # -I matrix compatibility == Potts(1).
        crf3 = DenseCRF(30, 3)
        crf3.set_unary_energy(unary)
        crf3.add_pairwise_energy(feats, PottsCompatibility(1.0))
        np.testing.assert_allclose(q2, np.asarray(crf3.inference(3)), rtol=1e-5)

    def test_crf2d_demo_shape(self):
        # Miniature dense_inference.cpp:83-110 configuration.
        rng = np.random.default_rng(8)
        w, h, m = 12, 10, 4
        rgb = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        unary = rng.normal(size=(w * h, m)).astype(np.float32)
        crf = DenseCRF2D(w, h, m)
        crf.set_unary_energy(unary)
        crf.add_pairwise_gaussian(3, 3, PottsCompatibility(3))
        crf.add_pairwise_bilateral(8, 8, 13, 13, 13, rgb, PottsCompatibility(10))
        labels = crf.map(5)
        assert labels.shape == (w * h,)
        assert set(np.unique(labels)) <= set(range(m))
        q = crf.inference(2)
        kl = crf.kl_divergence(q)
        assert np.isfinite(kl)


class TestLatticePadding:
    def test_padded_filter_identical(self):
        from rovinasemanticsegmentation_tpu.models.lattice import pad_lattice

        rng = np.random.default_rng(9)
        feats = rng.normal(size=(120, 6)).astype(np.float32) * 2
        lat = build_lattice(feats)
        padded = pad_lattice(lat, bucket=1024)
        assert padded.num_vertices >= lat.num_vertices
        assert padded.num_vertices % 1024 == 0
        vals = rng.normal(size=(120, 4)).astype(np.float32)
        np.testing.assert_allclose(
            _jax_filter(padded, vals), _jax_filter(lat, vals), rtol=1e-5, atol=1e-6
        )

    def test_exact_bucket_no_copy(self):
        from rovinasemanticsegmentation_tpu.models.lattice import pad_lattice

        rng = np.random.default_rng(10)
        feats = rng.normal(size=(20, 2)).astype(np.float32)
        lat = build_lattice(feats)
        padded = pad_lattice(lat, bucket=lat.num_vertices)
        assert padded is lat  # M already a bucket multiple


class TestFusedInference:
    """The one-dispatch fused loop == the readable step loop.

    models/crf.py::_fused_potts_inference replays the identical op
    sequence under lax.fori_loop; equality is tight (the only freedom is
    XLA fusion). Two kernels with different feature dims exercise the
    demo configuration (grid d=2 + bilateral d=5, dense_inference.cpp).
    """

    def _two_kernel_crf(self, ntype=None):
        rng = np.random.default_rng(11)
        n, c = 120, 5
        unary = rng.normal(size=(n, c)).astype(np.float32)
        f2 = rng.normal(size=(n, 2)).astype(np.float32)
        f5 = rng.normal(size=(n, 5)).astype(np.float32)
        crf = DenseCRF(n, c)
        crf.set_unary_energy(unary)
        kw = {} if ntype is None else {"ntype": ntype}
        crf.add_pairwise_energy(f2, PottsCompatibility(3.0), **kw)
        crf.add_pairwise_energy(f5, PottsCompatibility(10.0), **kw)
        return crf

    def test_fused_matches_step_loop(self):
        crf = self._two_kernel_crf()
        want = np.asarray(crf.inference(5, fused=False))
        got = np.asarray(crf.inference(5, fused=True))
        # XLA fuses the loop body differently from the eager op sequence;
        # the divergence is a few ULPs compounding per iteration (measured
        # max rel ~3e-6 at 5 iters on CPU), never an argmax flip here.
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)
        assert (got.argmax(1) == want.argmax(1)).all()
        # And the auto-selection picks the fused path for all-Potts.
        auto = np.asarray(crf.inference(5))
        np.testing.assert_array_equal(auto, got)

    def test_fused_respects_normalization_modes(self):
        from rovinasemanticsegmentation_tpu.models.crf import (
            NormalizationType,
        )

        for nt in (
            NormalizationType.NO_NORMALIZATION,
            NormalizationType.NORMALIZE_BEFORE,
            NormalizationType.NORMALIZE_AFTER,
        ):
            crf = self._two_kernel_crf(ntype=nt)
            want = np.asarray(crf.inference(3, fused=False))
            got = np.asarray(crf.inference(3, fused=True))
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)

    def test_non_potts_falls_back(self):
        rng = np.random.default_rng(12)
        n, c = 40, 3
        crf = DenseCRF(n, c)
        crf.set_unary_energy(rng.normal(size=(n, c)).astype(np.float32))
        crf.add_pairwise_energy(
            rng.normal(size=(n, 2)).astype(np.float32),
            DiagonalCompatibility([-1.0, -2.0, -0.5]),
        )
        # Auto must take the step loop (no fused non-Potts path) and agree
        # with the explicit step loop exactly.
        auto = np.asarray(crf.inference(3))
        step = np.asarray(crf.inference(3, fused=False))
        np.testing.assert_array_equal(auto, step)

    def test_map_from_labels_matches_host_unary(self):
        """Device-built unary (int8 label upload) == host-built unary.

        Same energies, same formula (dense_inference.cpp:37-52); the only
        difference is WHERE the [N, C] energy matrix materializes.
        """
        rng = np.random.default_rng(13)
        crf = self._two_kernel_crf()
        n, c = crf.n, crf.num_labels
        labels = rng.integers(-1, c, size=n).astype(np.int32)
        u_e, n_e, p_e = 1.25, 0.75, 0.5
        unary = np.full((n, c), u_e, np.float32)
        known = labels >= 0
        unary[known] = n_e
        unary[known, labels[known]] = p_e
        crf.set_unary_energy(unary)
        want = crf.map(4)
        got = crf.map_from_labels(labels, (u_e, n_e, p_e), 4)
        np.testing.assert_array_equal(got, want)

"""Checks that need the GPU: the descent kernel as the GPU's compiler builds
it, against the plain XLA descent. Skipped without a card; run with

    ROVINA_GPU_TESTS=1 python -m pytest tests/test_gpu.py -m gpu
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp

from rovinasemanticsegmentation_tpu.models.forest import (
    ForestPredictor,
    _find_leaves_packed,
    random_forest,
)
from rovinasemanticsegmentation_tpu.ops.forest_pallas import find_leaves_triton

pytestmark = pytest.mark.gpu


@pytest.mark.parametrize("trees,feats,points", [
    (4, 366, 76800), (5, 366, 1001), (2, 1500, 4097),
])
def test_descent_kernel_matches_xla(gpu_device, trees, feats, points):
    rng = np.random.default_rng(trees)
    forest = random_forest(rng, trees, 20, feats, [8, 9], max_nodes=4001)
    pred = ForestPredictor(forest)
    x = jnp.asarray(rng.normal(size=(points, feats)).astype(np.float32))
    got = np.asarray(
        find_leaves_triton(x, pred.records, pred.max_depth, pred.feat_bits)
    )
    want = np.asarray(
        _find_leaves_packed(x, pred.records, pred.max_depth, pred.feat_bits)
    )
    np.testing.assert_array_equal(got, want)


def test_pipeline_takes_the_kernel(gpu_device):
    from rovinasemanticsegmentation_tpu.features.extractor import FeatureConfig
    from rovinasemanticsegmentation_tpu.pipelines.single_frame import (
        SingleFramePipeline,
    )

    rng = np.random.default_rng(0)
    forest = random_forest(rng, 2, 4, 78, [3], max_nodes=15)
    pipe = SingleFramePipeline(
        FeatureConfig(patch_size=15, patch_size_reduce=5), forest, stride=2
    )
    assert pipe.descent == "triton"

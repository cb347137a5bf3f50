"""ROVINA semantic segmentation, rebuilt on JAX for the GPU.

A brand-new JAX/XLA/Pallas framework with the capabilities of
VisualComputingInstitute/RovinaSemanticSegmentation: per-pixel RGB-D feature
extraction, multi-label random-forest inference/training, dense-CRF mean-field
smoothing over local-map point clouds (permutohedral lattice), map fusion, and
the segmentation service API.

The reference stack is C++/OpenCV/PCL/ROS; this framework re-designs every
component as static-shape array programs:

- features: fused, batched XLA preprocessing (``features/``, ``ops/``)
- random forest: structure-of-arrays tensors + a Pallas (Triton) descent
  kernel on the GPU (``models/forest.py``, ``ops/forest_pallas.py``)
- dense CRF: static-shape permutohedral lattice + jitted splat/blur/slice
  (``models/crf.py``, ``models/lattice.py``)
- training: breadth-first, sort-based exact split search batched over frontier
  nodes (``train/``)
- scaling: jax.sharding meshes, DP over keyframes/trees, point-sharded CRF
  (``parallel/``)
- serving: queue-driven segmenter runtime and the four reference service
  schemas (``serve/``)
"""

__version__ = "0.1.0"

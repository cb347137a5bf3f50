"""2D dense-CRF demo (parity with densecrf's dense_inference example).

Usage: python -m rovinasemanticsegmentation_tpu.cli.dense_inference \
           <image.ppm> <annotation.ppm> <output.ppm>

Reproduces ``/root/reference/third-party/densecrf/examples/dense_inference.cpp:54-115``:
unary energies from a noisy annotation with GT_PROB = 0.5, a grid Gaussian
pairwise (sx = sy = 3, Potts 3) plus an appearance bilateral pairwise
(sx = sy = 80, sr = sg = sb = 13, Potts 10), 5 mean-field iterations, MAP,
and a colorized PPM where each label takes the color of its first
occurrence in the annotation (the example's getColor/putColor codec).
"""

from __future__ import annotations

import sys
from typing import Tuple

import numpy as np

from ..models.crf import DenseCRF2D, PottsCompatibility
from ..utils.imageio import load_ppm, save_ppm

M = 21  # number of labels, dense_inference.cpp:33
GT_PROB = 0.5  # dense_inference.cpp:35


def _first_appearance_ids(packed: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Label id per UNIQUE color, in order of first appearance (:43-49).

    Returns (uniq_colors, ids): pure black (0) and any color whose first
    appearance comes after M ids are taken map to -1 — exactly the
    reference's getColor bookkeeping, but looping only over the few dozen
    unique colors instead of every pixel (the per-pixel Python loop cost
    ~100 ms of the measured demo span).
    """
    uniq, first_idx, inverse = np.unique(
        packed, return_index=True, return_inverse=True
    )
    ids = np.full(len(uniq), -1, np.int32)
    next_id = 0
    for u in np.argsort(first_idx, kind="stable"):
        if uniq[u] == 0 or next_id >= M:
            continue
        ids[u] = next_id
        next_id += 1
    return uniq, ids[inverse], ids


def annotation_energies() -> Tuple[float, float, float]:
    """(unknown, non-matching, matching) unary energies (:37-41)."""
    return (
        -np.log(1.0 / M),
        -np.log((1.0 - GT_PROB) / (M - 1)),
        -np.log(GT_PROB),
    )


def annotation_labels(anno: np.ndarray) -> np.ndarray:
    """Label map [N] from the annotation's packed colors (:43-49)."""
    packed = (
        anno[..., 0].astype(np.int32)
        | (anno[..., 1].astype(np.int32) << 8)
        | (anno[..., 2].astype(np.int32) << 16)
    ).reshape(-1)
    _, labels, _ = _first_appearance_ids(packed)
    return labels


def unary_from_annotation(anno: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Classify the annotation into labels + unary energies (:37-52).

    Colors are assigned label ids in order of first appearance; pure black
    (0) is "unknown" (label -1). Returns (unary [N, M], labels [N]).
    """
    h, w = anno.shape[:2]
    labels = annotation_labels(anno)
    u_energy, n_energy, p_energy = annotation_energies()
    unary = np.full((h * w, M), u_energy, np.float32)
    known = labels >= 0
    unary[known] = n_energy
    unary[known, labels[known]] = p_energy
    return unary, labels


def colorize(map_labels: np.ndarray, anno: np.ndarray) -> np.ndarray:
    """Map labels back to their first-appearance colors (putColor)."""
    packed = (
        anno[..., 0].astype(np.int32)
        | (anno[..., 1].astype(np.int32) << 8)
        | (anno[..., 2].astype(np.int32) << 16)
    ).reshape(-1)
    uniq, _, uniq_ids = _first_appearance_ids(packed)
    palette = np.zeros((M, 3), np.uint8)
    has_id = uniq_ids >= 0
    cols = uniq[has_id]
    palette[uniq_ids[has_id]] = np.stack(
        [cols & 255, (cols >> 8) & 255, (cols >> 16) & 255], axis=1
    ).astype(np.uint8)
    return palette[map_labels]


def run(
    image_path: str,
    anno_path: str,
    out_path: str,
    iterations: int = 5,
    device_build: bool = False,
) -> np.ndarray:
    """``device_build`` builds the lattices on the device instead of the
    host; both paths match the reference's golden outputs, and
    ``scripts/bench_dense_inference.py`` times them."""
    im = load_ppm(image_path)
    anno = load_ppm(anno_path)
    h, w = im.shape[:2]
    labels = annotation_labels(anno)

    if device_build:
        from ..models.crf2d_device import dense2d_map_from_labels_device

        map_labels = dense2d_map_from_labels_device(
            im, labels, annotation_energies(), M, iterations
        )
    else:
        crf = DenseCRF2D(w, h, M)
        crf.add_pairwise_gaussian(3, 3, PottsCompatibility(3))
        crf.add_pairwise_bilateral(
            80, 80, 13, 13, 13, im, PottsCompatibility(10)
        )
        # Unary built on device from the int8 label map (map_from_labels):
        # same energies as unary_from_annotation, ~85x less upload.
        map_labels = crf.map_from_labels(
            labels, annotation_energies(), iterations
        )
    result = colorize(map_labels, anno).reshape(h, w, 3)
    save_ppm(out_path, result)
    return map_labels.reshape(h, w)


def main() -> None:
    if len(sys.argv) != 4:
        print("Usage: dense_inference <image.ppm> <annotation.ppm> <output.ppm>")
        raise SystemExit(1)
    run(sys.argv[1], sys.argv[2], sys.argv[3])


if __name__ == "__main__":
    main()

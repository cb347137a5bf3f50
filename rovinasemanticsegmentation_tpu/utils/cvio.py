"""Raw binary array IO and segment-id color codec.

Capability parity with ``Utils::SaveMat/ReadMat/segmentIdToBgr/bgrToSegmentId``
(``/root/reference/src/cv_util.cpp:14-142``), minus the interactive ``imshow``
debug helpers (observability here is file dumps, see ``serve/segmenter.py``).

File format (cv_util.cpp:30-39): five little-endian int32 header fields
``cols, rows, channels, elem_size, cv_type`` followed by the raw row-major
array bytes. ``cv_type`` follows OpenCV's ``CV_MAKETYPE(depth, channels)``
encoding so files written by the C++ tools load here and vice versa.
"""

from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

# OpenCV depth codes -> NumPy dtypes (core/hal/interface.h).
_CV_DEPTH_TO_DTYPE = {
    0: np.uint8,  # CV_8U
    1: np.int8,  # CV_8S
    2: np.uint16,  # CV_16U
    3: np.int16,  # CV_16S
    4: np.int32,  # CV_32S
    5: np.float32,  # CV_32F
    6: np.float64,  # CV_64F
}
_DTYPE_TO_CV_DEPTH = {np.dtype(v): k for k, v in _CV_DEPTH_TO_DTYPE.items()}


def _cv_maketype(depth: int, channels: int) -> int:
    return (depth & 7) + ((channels - 1) << 3)


def _cv_type_split(cv_type: int) -> Tuple[int, int]:
    return cv_type & 7, ((cv_type >> 3) & 63) + 1


def save_mat(filename: str, data: np.ndarray) -> None:
    """Write an array in the reference binary format (cv_util.cpp:14-45).

    2-D arrays are single-channel; a trailing dim of size C<=512 becomes the
    channel count.
    """
    data = np.ascontiguousarray(data)
    if data.size == 0:
        raise ValueError(f"No data was provided for saving to file: {filename}")
    if data.ndim == 2:
        rows, cols, chan = data.shape[0], data.shape[1], 1
    elif data.ndim == 3:
        rows, cols, chan = data.shape
    else:
        raise ValueError("save_mat expects a 2-D or 3-D array")
    depth = _DTYPE_TO_CV_DEPTH[np.dtype(data.dtype)]
    esiz = data.dtype.itemsize
    cv_type = _cv_maketype(depth, chan)
    with open(filename, "wb") as f:
        f.write(struct.pack("<5i", cols, rows, chan, esiz, cv_type))
        f.write(data.tobytes())


def read_mat(filename: str) -> np.ndarray:
    """Read an array in the reference binary format (cv_util.cpp:47-75).

    Returns [rows, cols] for single-channel data, [rows, cols, channels]
    otherwise.
    """
    with open(filename, "rb") as f:
        header = f.read(20)
        cols, rows, chan, esiz, cv_type = struct.unpack("<5i", header)
        depth, type_chan = _cv_type_split(cv_type)
        if type_chan != chan:
            raise ValueError(
                f"Inconsistent header in {filename}: channels {chan} vs type {type_chan}"
            )
        dtype = np.dtype(_CV_DEPTH_TO_DTYPE[depth])
        if dtype.itemsize != esiz:
            raise ValueError(
                f"Inconsistent header in {filename}: elem size {esiz} vs dtype {dtype}"
            )
        buf = f.read(cols * rows * chan * esiz)
    arr = np.frombuffer(buf, dtype=dtype).reshape(
        (rows, cols) if chan == 1 else (rows, cols, chan)
    )
    return arr.copy()


# ----------------------------------------------------------------------
# Segment-id <-> color codec: a 24-bit bit-permutation spreading consecutive
# ids across visually distinct colors (cv_util.cpp:84-142), vectorized.
# Bit i of the id goes to channel (i % 3) at bit position (7 - i // 3).
# ----------------------------------------------------------------------


def segment_id_to_rgb(indices: np.ndarray) -> np.ndarray:
    """[H, W] int32 ids -> [H, W, 3] uint8 RGB (cv_util.cpp:88-115)."""
    idx = np.asarray(indices).astype(np.int64)
    rgb = np.zeros(idx.shape + (3,), dtype=np.uint8)
    for i in range(24):
        val = ((idx >> i) & 1).astype(np.uint8)
        rgb[..., i % 3] |= val << (7 - i // 3)
    return rgb


def rgb_to_segment_id(rgb: np.ndarray) -> np.ndarray:
    """[H, W, 3] uint8 RGB -> [H, W] int32 ids (cv_util.cpp:116-142)."""
    rgb = np.asarray(rgb)
    out = np.zeros(rgb.shape[:-1], dtype=np.int32)
    for i in range(24):
        bit = (rgb[..., i % 3].astype(np.int32) >> (7 - i // 3)) & 1
        out |= bit << i
    return out


# ----------------------------------------------------------------------
# Debug visualization helpers. The reference pops interactive windows
# (ShowCvMat/ShowCvMatHeatMap, cv_util.cpp:77-81,145-154); headless hosts
# write files instead.
# ----------------------------------------------------------------------


def _jet_colormap(values: np.ndarray) -> np.ndarray:
    """[0,1] floats -> uint8 RGB, OpenCV COLORMAP_JET-style."""
    v = np.clip(np.asarray(values, np.float64), 0.0, 1.0)
    four = 4.0 * v
    r = np.clip(np.minimum(four - 1.5, -four + 4.5), 0, 1)
    g = np.clip(np.minimum(four - 0.5, -four + 3.5), 0, 1)
    b = np.clip(np.minimum(four + 0.5, -four + 2.5), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def save_heatmap(filename: str, data: np.ndarray) -> None:
    """Min-max normalized jet heatmap PNG (ShowCvMatHeatMap equivalent)."""
    from .imageio import save_color

    data = np.asarray(data, np.float64)
    lo, hi = float(np.nanmin(data)), float(np.nanmax(data))
    scale = (data - lo) / (hi - lo) if hi > lo else np.zeros_like(data)
    save_color(filename, _jet_colormap(np.nan_to_num(scale)))


def save_gray(filename: str, data: np.ndarray) -> None:
    """Min-max normalized grayscale PNG (ShowCvMat equivalent for floats)."""
    from .imageio import save_color

    data = np.asarray(data, np.float64)
    lo, hi = float(np.nanmin(data)), float(np.nanmax(data))
    scale = (data - lo) / (hi - lo) if hi > lo else np.zeros_like(data)
    g = (np.nan_to_num(scale) * 255).astype(np.uint8)
    save_color(filename, np.stack([g, g, g], axis=-1))

"""ArUco marker dictionaries (L2) — JAX replacement for OpenCV's
``cv::aruco::getPredefinedDictionary`` (reference src/aruco_slam.cpp:11-12)
and the dictionary-lookup stage of ``detectMarkers`` (:313).

``DICT_ARUCO_ORIGINAL`` (id 16, the reference's dictionary —
parameters.yaml:16) is *generated*, not tabulated: each of the 5 rows of
the 5x5 bit grid encodes 2 id bits (MSB-first) with the classic ArUco
code words

    00 -> 10000    01 -> 10111    10 -> 01001    11 -> 01110

giving 1024 markers. Verified bit-exact against OpenCV's bytesList in
tests/test_detector.py. Matching is a single [K, 25] x [25, 4096] matmul
(all 4 rotations of all 1024 codes), one shot per frame.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array

ARUCO_ORIGINAL_WORDS = np.array(
    [
        [1, 0, 0, 0, 0],  # 00
        [1, 0, 1, 1, 1],  # 01
        [0, 1, 0, 0, 1],  # 10
        [0, 1, 1, 1, 0],  # 11
    ],
    np.uint8,
)


@functools.lru_cache(maxsize=None)
def aruco_original_bits() -> np.ndarray:
    """All 1024 DICT_ARUCO_ORIGINAL markers as [1024, 5, 5] {0,1} arrays
    (1 = white cell on the printed marker, matching OpenCV's convention)."""
    ids = np.arange(1024)
    rows = []
    for i in range(5):
        two = (ids >> (2 * (4 - i))) & 0b11  # [1024]
        rows.append(ARUCO_ORIGINAL_WORDS[two])  # [1024, 5]
    return np.stack(rows, axis=1)  # [1024, 5, 5]


@functools.lru_cache(maxsize=None)
def aruco_original_rotations() -> np.ndarray:
    """[4, 1024, 25]: all four 90-degree rotations of every codeword,
    flattened row-major. Rotation r equals np.rot90(bits, r) — the same
    slot layout as OpenCV's bytesList (verified in tests)."""
    bits = aruco_original_bits()
    rots = [np.rot90(bits, r, axes=(1, 2)).reshape(1024, 25) for r in range(4)]
    return np.stack(rots)


def match_bits(bits: Array, max_correction: int = 1):
    """Match extracted 5x5 bit grids against the dictionary.

    ``bits [..., 5, 5]`` (uint/bool, 1 = white) ->
    (ids [...], rotations [...], distances [...], valid [...]).

    Hamming distance to all 4096 (rotation, id) codewords via one matmul:
    d = 25 - same = 25 - (b . c + (1-b) . (1-c)). ``max_correction``
    mirrors OpenCV's maxCorrectionBits (1 for ARUCO_ORIGINAL at the default
    0.6 error-correction rate: int(3 * 0.6) = 1).
    """
    codes = jnp.asarray(
        aruco_original_rotations().reshape(4 * 1024, 25), jnp.float32
    )
    b = bits.reshape(*bits.shape[:-2], 25).astype(jnp.float32)
    same = b @ codes.T + (1.0 - b) @ (1.0 - codes.T)  # [..., 4096]
    dist = 25.0 - same
    best = jnp.argmin(dist, axis=-1)
    d = jnp.take_along_axis(dist, best[..., None], axis=-1)[..., 0]
    rot = (best // 1024).astype(jnp.int32)
    mid = (best % 1024).astype(jnp.int32)
    return mid, rot, d, d <= max_correction


def marker_pattern(marker_id: int, cells: int = 7) -> np.ndarray:
    """Full printed pattern including the 1-cell black border:
    [cells, cells] {0,1}, 1 = white. cells = 5 + 2 for ARUCO_ORIGINAL."""
    assert cells == 7
    out = np.zeros((7, 7), np.uint8)
    out[1:6, 1:6] = aruco_original_bits()[marker_id]
    return out

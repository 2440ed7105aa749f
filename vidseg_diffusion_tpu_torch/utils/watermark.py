"""Invisible DWT-DCT watermark: embed, decode and match classification
(numpy only).

The port's own copy of vidseg_diffusion_tpu/utils/watermark.py, which
imports no JAX: the reference's embed side (sgm/inference/helpers.py:16-59,
imwatermark's dwtDct encoder with a fixed 48-bit message) and its detection
CLI's decoder and confidence buckets (scripts/demo/detect.py:1-156). The
scheme, written in numpy: YUV transform, one-level Haar DWT, 4x4 block DCT,
the bit embedded in the quantized top singular value of each block. Numerics
differ from imwatermark at the margin (uint8 rounding in the colour
transform); the scheme, message, block layout, scales and confidence
thresholds are the same. The hot path never watermarks.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

# The reference's fixed 48-bit message (detect.py:53-56; chosen at random
# upstream and baked into every release).
WATERMARK_MESSAGE = 0b101100111110110010010000011110111011000110011110
WATERMARK_BITS: Tuple[int, ...] = tuple(
    int(b) for b in bin(WATERMARK_MESSAGE)[2:]
)

# matched-bits -> confidence buckets (detect.py:57-77)
MATCH_VALUES: Tuple[Tuple[int, str], ...] = (
    (27, "No watermark detected"),
    (33, "Partial watermark match. Cannot determine with certainty."),
    (
        35,
        'Likely watermarked. In our test 0.02% of real images were '
        'falsely detected as "Likely watermarked"',
    ),
    (
        49,
        'Very likely watermarked. In our test no real images were '
        'falsely detected as "Very likely watermarked"',
    ),
)

# dwtDct defaults (imwatermark EmbedMaxDct): embed in the U chroma plane
# (scales [0, 36, 36] with only channels 0..1 visited upstream), 4x4 blocks
_SCALE = 36.0
_BLOCK = 4


def _dct_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II basis (rows), matching cv2.dct for square input."""
    k = np.arange(n)[:, None]
    i = np.arange(n)[None, :]
    m = np.cos(np.pi * (2 * i + 1) * k / (2 * n)) * np.sqrt(2.0 / n)
    m[0] /= np.sqrt(2.0)
    return m


_DCT4 = _dct_matrix(_BLOCK)


def _rgb_to_yuv(rgb: np.ndarray) -> np.ndarray:
    """float RGB [0,255] -> YUV with the 8-bit delta-128 chroma convention."""
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    u = 0.492 * (b - y) + 128.0
    v = 0.877 * (r - y) + 128.0
    return np.stack([y, u, v], axis=-1)


def _yuv_to_rgb(yuv: np.ndarray) -> np.ndarray:
    y, u, v = yuv[..., 0], yuv[..., 1], yuv[..., 2]
    b = (u - 128.0) / 0.492 + y
    r = (v - 128.0) / 0.877 + y
    g = (y - 0.299 * r - 0.114 * b) / 0.587
    return np.stack([r, g, b], axis=-1)


def _haar_dwt2(x: np.ndarray):
    """One-level 2-D Haar DWT (pywt 'haar' normalization: /2 per band)."""
    a = x[0::2, 0::2]
    b = x[0::2, 1::2]
    c = x[1::2, 0::2]
    d = x[1::2, 1::2]
    ll = (a + b + c + d) / 2.0
    lh = (a - b + c - d) / 2.0
    hl = (a + b - c - d) / 2.0
    hh = (a - b - c + d) / 2.0
    return ll, (lh, hl, hh)


def _haar_idwt2(ll, bands):
    lh, hl, hh = bands
    a = (ll + lh + hl + hh) / 2.0
    b = (ll - lh + hl - hh) / 2.0
    c = (ll + lh - hl - hh) / 2.0
    d = (ll - lh - hl + hh) / 2.0
    h, w = ll.shape
    out = np.empty((2 * h, 2 * w), dtype=ll.dtype)
    out[0::2, 0::2] = a
    out[0::2, 1::2] = b
    out[1::2, 0::2] = c
    out[1::2, 1::2] = d
    return out


def _blocks(ll: np.ndarray):
    """[H, W] -> [n, 4, 4] raster-ordered non-overlapping blocks + shape."""
    bh, bw = ll.shape[0] // _BLOCK, ll.shape[1] // _BLOCK
    trimmed = ll[: bh * _BLOCK, : bw * _BLOCK]
    blk = trimmed.reshape(bh, _BLOCK, bw, _BLOCK).transpose(0, 2, 1, 3)
    return blk.reshape(bh * bw, _BLOCK, _BLOCK), (bh, bw)


def _unblocks(blk: np.ndarray, shape) -> np.ndarray:
    bh, bw = shape
    return (
        blk.reshape(bh, bw, _BLOCK, _BLOCK)
        .transpose(0, 2, 1, 3)
        .reshape(bh * _BLOCK, bw * _BLOCK)
    )


def _embed_plane(ll: np.ndarray, bits: Sequence[int], scale: float) -> np.ndarray:
    """diffuse_dct_svd over every block: s0 -> (s0//scale + 0.25 + 0.5*bit)*scale."""
    blk, shape = _blocks(ll)
    dct = _DCT4 @ blk @ _DCT4.T
    u, s, vt = np.linalg.svd(dct)
    bit = np.asarray(
        [bits[i % len(bits)] for i in range(blk.shape[0])], dtype=np.float64
    )
    s[:, 0] = (np.floor(s[:, 0] / scale) + 0.25 + 0.5 * bit) * scale
    rec = u @ (s[..., None] * vt)
    out = _DCT4.T @ rec @ _DCT4
    res = ll.copy()
    res[: shape[0] * _BLOCK, : shape[1] * _BLOCK] = _unblocks(out, shape)
    return res


def _decode_plane(ll: np.ndarray, n_bits: int, scale: float) -> List[List[float]]:
    blk, _ = _blocks(ll)
    dct = _DCT4 @ blk @ _DCT4.T
    s = np.linalg.svd(dct, compute_uv=False)
    score = ((s[:, 0] % scale) > scale * 0.5).astype(np.float64)
    out: List[List[float]] = [[] for _ in range(n_bits)]
    for i, sc in enumerate(score):
        out[i % n_bits].append(sc)
    return out


def _infer_unit_range(frames: np.ndarray, unit_range) -> bool:
    """[0,1] vs [0,255] decision: explicit flag > integer dtype (always
    byte range) > float max heuristic. The heuristic alone misread
    near-black [0,255] images (max <= 1.5) as unit range and returned
    them ~255x darker."""
    if unit_range is not None:
        return bool(unit_range)
    if np.issubdtype(np.asarray(frames).dtype, np.integer):
        return False
    return float(np.max(frames)) <= 1.5


def embed_watermark_frames(
    frames: np.ndarray, bits: Sequence[int] = WATERMARK_BITS,
    unit_range: bool = None,
) -> np.ndarray:
    """Embed the watermark into [B, H, W, 3] (or [H, W, 3]) RGB frames.

    Accepts [0, 1] floats or [0, 255]; returns the same range/dtype family
    (float). Pass `unit_range` explicitly for near-black float frames
    (see _infer_unit_range). Images smaller than 256x256 pass through
    unchanged (the decoder refuses them, detect.py:39)."""
    unit_range = _infer_unit_range(frames, unit_range)
    frames = np.asarray(frames, np.float64)
    squeeze = frames.ndim == 3
    if squeeze:
        frames = frames[None]
    px = frames * 255.0 if unit_range else frames.copy()
    out = np.empty_like(px)
    for i, img in enumerate(px):
        if img.shape[0] * img.shape[1] < 256 * 256:
            out[i] = img
            continue
        yuv = _rgb_to_yuv(img)
        h4, w4 = (img.shape[0] // 4) * 4, (img.shape[1] // 4) * 4
        ll, bands = _haar_dwt2(yuv[:h4, :w4, 1])
        ll = _embed_plane(ll, bits, _SCALE)
        yuv[:h4, :w4, 1] = _haar_idwt2(ll, bands)
        out[i] = np.clip(_yuv_to_rgb(yuv), 0.0, 255.0)
    res = out / 255.0 if unit_range else out
    return res[0] if squeeze else res


def decode_watermark_bits(
    frames: np.ndarray, n_bits: int = len(WATERMARK_BITS),
    unit_range: bool = None,
) -> np.ndarray:
    """Reconstruct the embedded bits from RGB frames -> [B, n_bits] (0/1)."""
    unit_range = _infer_unit_range(frames, unit_range)
    frames = np.asarray(frames, np.float64)
    squeeze = frames.ndim == 3
    if squeeze:
        frames = frames[None]
    px = frames * 255.0 if unit_range else frames
    res = np.empty((px.shape[0], n_bits), dtype=np.int64)
    for i, img in enumerate(px):
        if img.shape[0] * img.shape[1] < 256 * 256:
            raise ValueError("image too small, should be larger than 256x256")
        yuv = _rgb_to_yuv(img)
        h4, w4 = (img.shape[0] // 4) * 4, (img.shape[1] // 4) * 4
        ll, _ = _haar_dwt2(yuv[:h4, :w4, 1])
        scores = _decode_plane(ll, n_bits, _SCALE)
        avg = np.array([np.mean(s) if s else 0.0 for s in scores])
        res[i] = (avg * 255.0 > 127.0).astype(np.int64)
    return res[0] if squeeze else res


def watermark_match_bits(frames: np.ndarray) -> np.ndarray:
    """Number of decoded bits matching the fixed message ([B] or scalar) —
    GetWatermarkMatch semantics (detect.py:80-106)."""
    bits = decode_watermark_bits(frames)
    wm = np.asarray(WATERMARK_BITS)
    return np.sum(bits == wm, axis=-1)


def classify_match(num_bits: int) -> str:
    """Map a matched-bit count to the reference's confidence message
    (detect.py:147-149 threshold walk)."""
    k = 0
    while k < len(MATCH_VALUES) - 1 and num_bits > MATCH_VALUES[k][0]:
        k += 1
    return MATCH_VALUES[k][1]

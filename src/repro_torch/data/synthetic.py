"""Procedural image datasets (no MNIST/CIFAR files are needed).

A copy of the JAX package's ``data/synthetic.py``, kept here because the
port imports nothing of that package: for the same ``seed`` both give
byte-identical images and labels (NHWC, as the reference's).

``digits_dataset`` renders 10 digit glyphs (7x5 bitmaps) onto 28x28 canvases
with per-sample affine jitter (shift/scale) + pixel noise — a MNIST stand-in
with a real accuracy signal (LeNet reaches >95% top-1 in ~1 min on CPU).

``shapes32_dataset`` renders 10 colored-shape classes on textured 32x32x3
canvases — the CIFAR10 stand-in for Convnet/AlexNet-small.

Pure numpy, fully determined by ``seed``.
"""
from __future__ import annotations

import numpy as np

_GLYPHS = [
    # 7 rows x 5 cols, digits 0-9
    ["01110", "10001", "10011", "10101", "11001", "10001", "01110"],  # 0
    ["00100", "01100", "00100", "00100", "00100", "00100", "01110"],  # 1
    ["01110", "10001", "00001", "00110", "01000", "10000", "11111"],  # 2
    ["01110", "10001", "00001", "00110", "00001", "10001", "01110"],  # 3
    ["00010", "00110", "01010", "10010", "11111", "00010", "00010"],  # 4
    ["11111", "10000", "11110", "00001", "00001", "10001", "01110"],  # 5
    ["01110", "10000", "10000", "11110", "10001", "10001", "01110"],  # 6
    ["11111", "00001", "00010", "00100", "01000", "01000", "01000"],  # 7
    ["01110", "10001", "10001", "01110", "10001", "10001", "01110"],  # 8
    ["01110", "10001", "10001", "01111", "00001", "00001", "01110"],  # 9
]


def _glyph_array(d: int) -> np.ndarray:
    return np.array([[int(c) for c in row] for row in _GLYPHS[d]], np.float32)


def _render_digit(rng: np.random.Generator, d: int, size: int = 28):
    g = _glyph_array(d)  # (7,5)
    scale = rng.uniform(2.2, 3.2)
    gh, gw = int(7 * scale), int(5 * scale)
    ys = (np.arange(gh) / scale).astype(int).clip(0, 6)
    xs = (np.arange(gw) / scale).astype(int).clip(0, 4)
    big = g[np.ix_(ys, xs)]
    canvas = np.zeros((size, size), np.float32)
    oy = rng.integers(1, size - gh - 1) if size - gh - 2 > 1 else 1
    ox = rng.integers(1, size - gw - 1) if size - gw - 2 > 1 else 1
    canvas[oy:oy + gh, ox:ox + gw] = big
    # stroke-intensity jitter + blur-ish neighborhood + noise
    canvas *= rng.uniform(0.7, 1.0)
    canvas += rng.normal(0.0, 0.08, canvas.shape).astype(np.float32)
    return canvas.clip(0.0, 1.0)


def digits_dataset(n: int, seed: int = 0):
    """Returns (images (n,28,28,1) f32 in [0,1], labels (n,) int32)."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = np.stack([_render_digit(rng, int(d)) for d in labels])
    return imgs[..., None].astype(np.float32), labels


# ---------------------------------------------------------------------------
# 32x32x3 shapes (CIFAR stand-in): class = (shape kind, hue family)
# ---------------------------------------------------------------------------
def _draw_shape(rng, kind: int, size: int = 32):
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    cy = rng.uniform(10, size - 10)
    cx = rng.uniform(10, size - 10)
    r = rng.uniform(5, 9)
    if kind == 0:      # disk
        m = ((yy - cy) ** 2 + (xx - cx) ** 2) < r * r
    elif kind == 1:    # square
        m = (np.abs(yy - cy) < r) & (np.abs(xx - cx) < r)
    elif kind == 2:    # diamond
        m = (np.abs(yy - cy) + np.abs(xx - cx)) < r * 1.3
    elif kind == 3:    # ring
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        m = (d2 < r * r) & (d2 > (0.55 * r) ** 2)
    else:              # cross
        m = ((np.abs(yy - cy) < r * 0.35) & (np.abs(xx - cx) < r)) | \
            ((np.abs(xx - cx) < r * 0.35) & (np.abs(yy - cy) < r))
    return m.astype(np.float32)


_HUES = [(1.0, 0.2, 0.2), (0.2, 0.6, 1.0)]  # warm / cold


def shapes32_dataset(n: int, seed: int = 0):
    """10 classes = 5 shapes x 2 hue families. Returns ((n,32,32,3), (n,))."""
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, n).astype(np.int32)
    imgs = np.empty((n, 32, 32, 3), np.float32)
    for i, lab in enumerate(labels):
        kind, hue = int(lab) % 5, int(lab) // 5
        bg = rng.uniform(0.0, 0.35) + \
            rng.normal(0, 0.06, (32, 32, 3)).astype(np.float32)
        m = _draw_shape(rng, kind)
        col = np.array(_HUES[hue], np.float32) * rng.uniform(0.7, 1.0)
        img = bg + m[..., None] * col[None, None, :]
        imgs[i] = img.clip(0.0, 1.0)
    return imgs, labels

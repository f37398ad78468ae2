"""The port's stand-in for the OpenCV calls of the JAX package's readers,
in numpy and zlib: PNG decoding, resizing, undistortion and remapping.

Each function names the cv2 call it replaces and gives what that call
gives, bit for bit where OpenCV's integer arithmetic is replicated:

- ``imread``: ``cv2.imread`` (IMREAD_COLOR, or IMREAD_ANYDEPTH) of PNGs,
  and of baseline, progressive and arithmetic-coded JPEGs (IMREAD_COLOR)
  through data/jpeg.py;
- ``resize``: ``cv2.resize`` with INTER_LINEAR (uint8: OpenCV's 11-bit
  fixed point; float: float weights) or INTER_NEAREST;
- ``init_undistort_rectify_map``: ``cv2.initUndistortRectifyMap`` (CV_32F);
- ``Remap`` / ``remap``: ``cv2.remap`` with INTER_LINEAR and a constant zero
  border (OpenCV's 1/32-pixel fixed point and 15-bit weights);
- ``undistort``: ``cv2.undistort``.

The card's machine has no OpenCV and no PIL; these are what its readers use.
"""
import os
import struct
import zlib

import numpy as np

from . import jpeg

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}      # PNG colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (x0, y0, dx, dy) of each of the 7 passes of an interlaced PNG
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
          (0, 1, 1, 2))


def _read_png(path):
    """Decode a PNG into [H, W, C] samples (uint8, or uint16 at 16 bits) in
    the file's channel order: grey, RGB, grey + alpha or RGBA; a palette
    image becomes RGB through its PLTE, and grey below 8 bits is scaled to
    8 (libpng's expand transforms, which OpenCV asks for)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, header, palette = 8, [], None, None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos: pos + 8])
        body = blob[pos + 8: pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    w, h, depth, ctype, _, _, interlace = header
    if ctype not in _CHANNELS or depth not in _DEPTHS[ctype]:
        raise ValueError(f"{path}: PNG colour type {ctype} at bit depth {depth} does not exist")
    if ctype == 3 and palette is None:
        raise ValueError(f"{path}: palette PNG without a PLTE chunk")
    ch = _CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if interlace:
        px = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
        ofs = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:     # an empty pass has no rows, not even filter bytes
                sub, n = _decode_rows(raw[ofs:], pw, ph, ch, depth)
                px[y0::dy, x0::dx] = sub
                ofs += n
    else:
        px = _decode_rows(raw, w, h, ch, depth)[0]
    if ctype == 3:
        if int(px.max(initial=0)) >= len(palette):
            raise ValueError(f"{path}: palette index beyond the PLTE's {len(palette)} entries")
        return palette[px[..., 0]]
    if depth < 8:
        px = px * np.uint8(255 // (2 ** depth - 1))
    return px


def _decode_rows(raw, w, h, ch, depth):
    """Unfilter and unpack h rows of w pixels from the start of raw: the
    samples [h, w, ch] and the bytes used."""
    row = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    n = h * (1 + row)
    if raw.size < n:
        raise ValueError("PNG image data is truncated")
    rows = raw[:n].reshape(h, 1 + row)
    data = _unfilter(rows[:, 0], rows[:, 1:].reshape(h, row // bpp, bpp)).reshape(h, row)
    if depth == 16:
        return data.view(">u2").astype(np.uint16).reshape(h, w, ch), n
    if depth == 8:
        return data.reshape(h, w, ch), n
    bits = np.unpackbits(data, axis=1)[:, :w * depth].reshape(h, w, depth)
    weights = (1 << np.arange(depth - 1, -1, -1)).astype(np.uint8)
    return (bits * weights).sum(-1, dtype=np.uint8)[..., None], n


def _unfilter(ftype, data):
    """Undo the PNG row filters: ftype [H] (0 none, 1 sub, 2 up, 3 average,
    4 paeth), data [H, W, bpp] filtered bytes.  Filters act on each byte
    lane modulo 256."""
    if ftype.max(initial=0) > 4:
        raise ValueError(f"PNG row filter {int(ftype.max())} does not exist")
    if ftype.max(initial=0) <= 2:
        # none and sub rows stand alone (sub: a running sum along the row);
        # an up row adds the row above, so a run of up rows is a running sum
        # down the rows from the last row that stands alone
        own = np.where((ftype == 1)[:, None, None], data.cumsum(axis=1, dtype=np.uint8), data)
        total = own.cumsum(axis=0, dtype=np.uint8)
        start = np.maximum.accumulate(np.where(ftype != 2, np.arange(len(ftype)), -1))
        before = np.where((start > 0)[:, None, None], total[np.maximum(start - 1, 0)], 0)
        return (total - before).astype(np.uint8)
    return _unfilter_diagonals(ftype, data)


def _unfilter_diagonals(ftype, data):
    """Average and paeth rows need the reconstructed left, upper and
    upper-left bytes, so the pixels of one anti-diagonal (x + y = d) are
    independent: the loop runs over the H + W - 1 diagonals of a skewed copy,
    each step vectorised over its rows."""
    h, w, bpp = data.shape
    rows = np.arange(h)[:, None]
    # skewed[y + 1, y + x + 1] = pixel (y, x); row 0 and each row's column y
    # stay zero: the PNG's zero neighbours above the image and left of it
    skewed = np.zeros((h + 1, h + w + 1, bpp), np.int16)
    filt = np.zeros((h, h + w, bpp), np.int16)
    filt[rows, rows + np.arange(w)] = data
    masks = {k: (ftype == k).astype(np.int16)[:, None] for k in (1, 2, 3, 4) if (ftype == k).any()}
    for d in range(h + w - 1):
        lo, hi = max(0, d - w + 1), min(h - 1, d) + 1
        a = skewed[lo + 1: hi + 1, d]        # left
        b = skewed[lo: hi, d]                # up
        acc = filt[lo: hi, d].copy()
        if 1 in masks:
            acc += a * masks[1][lo: hi]
        if 2 in masks:
            acc += b * masks[2][lo: hi]
        if 3 in masks:
            acc += ((a + b) >> 1) * masks[3][lo: hi]
        if 4 in masks:
            c = skewed[lo: hi, d - 1] if d else np.zeros_like(a)     # up-left
            pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
            paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
            acc += paeth * masks[4][lo: hi]
        skewed[lo + 1: hi + 1, d + 1] = acc & 255
    return skewed[rows + 1, rows + 1 + np.arange(w)].astype(np.uint8)


def imread(path, anydepth=False):
    """``cv2.imread(path)`` of a PNG: [H, W, 3] uint8 BGR, grey replicated,
    alpha dropped, 16-bit samples reduced to their high byte.

    anydepth: ``cv2.imread(path, cv2.IMREAD_ANYDEPTH)`` of a grey PNG: [H, W]
    at the file's depth (uint16 for TUM's and ETH3D's depth maps).

    PNG: every colour type and bit depth, interlaced or not.  JPEG
    (``.jpg``/``.jpeg``): baseline, extended sequential, progressive and
    arithmetic-coded (data/jpeg.py); lossless, hierarchical, 12-bit and
    CMYK JPEGs raise NotImplementedError.
    IMREAD_ANYDEPTH reads grey PNGs only.
    """
    if anydepth:
        px = _read_png(_png_path(path))
        if px.shape[2] > 2:
            raise NotImplementedError(f"{path}: IMREAD_ANYDEPTH of a colour PNG")
        return px[..., 0]
    img = read_bgr(path)
    return np.repeat(img, 3, axis=2) if img.shape[2] == 1 else img


def read_bgr(path):
    """``imread(path)`` before grey is replicated: [H, W, 1] for a grey PNG,
    else [H, W, 3] BGR.  Resizing and remapping act on each channel alone,
    so a reader may do them on one grey channel and replicate it after."""
    path = os.fspath(path)
    if path.lower().endswith((".jpg", ".jpeg")):
        with open(path, "rb") as f:
            return jpeg.decode(f.read(), path)
    px = _read_png(_png_path(path))
    if px.dtype == np.uint16:
        px = (px >> 8).astype(np.uint8)
    if px.shape[2] <= 2:
        return np.ascontiguousarray(px[..., :1])
    return np.ascontiguousarray(px[..., 2::-1])


def _png_path(path):
    path = os.fspath(path)
    if not path.lower().endswith(".png"):
        raise NotImplementedError(f"{path}: only PNG and JPEG images are decoded")
    return path


# ---------------------------------------------------------------- resize

_COEF_SCALE = 2048      # OpenCV's INTER_RESIZE_COEF_SCALE (11 bits)


def _linear_taps(n0, n1, clamp_weights):
    """Source indices (i0, i1) and float32 weights (1 - f, f) of OpenCV's
    INTER_LINEAR along one axis: f from (d + 0.5) * scale - 0.5 in float32,
    with scale = 1 / (n1 / n0) as OpenCV computes it.  Along x a tap off the
    image takes the border pixel with weight 1 (clamp_weights); along y the
    rows are clamped and the weights kept, as OpenCV does."""
    scale = 1.0 / (n1 / n0)
    fx = ((np.arange(n1) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(fx).astype(np.int64)
    fx = fx - i0.astype(np.float32)
    if clamp_weights:
        fx[(i0 < 0) | (i0 >= n0 - 1)] = 0.0
    return np.clip(i0, 0, n0 - 1), np.clip(i0 + 1, 0, n0 - 1), np.float32(1.0) - fx, fx


def _along(x, n, axis):
    """Broadcast a per-index vector x [n] along `axis` of an image."""
    shape = [1] * n
    shape[axis] = -1
    return x.reshape(shape)


def resize(img, size, interp="linear"):
    """``cv2.resize(img, size, interpolation=...)``: size is (w, h).

    "linear" (INTER_LINEAR) on uint8 replicates OpenCV's fixed point: 11-bit
    weights, horizontal sums in int32, then the vertical blend
    ``((b0 * (r0 >> 4)) >> 16) + ((b1 * (r1 >> 4)) >> 16) + 2 >> 2``; on a
    float image, the same taps with float32 weights.  "nearest"
    (INTER_NEAREST) takes source index ``min(floor(d * (1 / (n1 / n0))), n0 - 1)``.
    """
    img = np.asarray(img)
    w1, h1 = size
    h0, w0 = img.shape[:2]
    if interp == "nearest":
        ys = np.minimum(np.floor(np.arange(h1) * (1.0 / (h1 / h0))).astype(np.int64), h0 - 1)
        xs = np.minimum(np.floor(np.arange(w1) * (1.0 / (w1 / w0))).astype(np.int64), w0 - 1)
        return img[ys][:, xs]
    if interp != "linear":
        raise ValueError(f"interp must be 'linear' or 'nearest', got {interp!r}")
    x0, x1, ax0, ax1 = _linear_taps(w0, w1, True)
    y0, y1, by0, by1 = _linear_taps(h0, h1, False)
    nd = img.ndim
    if img.dtype == np.uint8:
        ax0, ax1, by0, by1 = (np.rint(a * _COEF_SCALE).astype(np.int32)
                              for a in (ax0, ax1, by0, by1))
        src = img.astype(np.int32)
        rows = src[:, x0] * _along(ax0, nd, 1) + src[:, x1] * _along(ax1, nd, 1)
        r0, r1 = rows[y0] >> 4, rows[y1] >> 4
        out = ((((_along(by0, nd, 0) * r0) >> 16) + ((_along(by1, nd, 0) * r1) >> 16) + 2) >> 2)
        return np.clip(out, 0, 255).astype(np.uint8)
    if not np.issubdtype(img.dtype, np.floating):
        raise NotImplementedError(f"linear resize of {img.dtype} images")
    dt = img.dtype
    rows = img[:, x0] * _along(ax0, nd, 1).astype(dt) + img[:, x1] * _along(ax1, nd, 1).astype(dt)
    return rows[y0] * _along(by0, nd, 0).astype(dt) + rows[y1] * _along(by1, nd, 0).astype(dt)


# ------------------------------------------------------- undistort, remap

def _undistort_rectify_map64(K, D, R, P, size):
    """``cv2.initUndistortRectifyMap`` in float64: for each output pixel, the
    source pixel (u, v) of the distorted image.  D: 4, 5 or 8 coefficients
    (k1, k2, p1, p2[, k3[, k4, k5, k6]])."""
    w, h = size
    K = np.asarray(K, np.float64)
    D = np.zeros(8) if D is None else np.asarray(D, np.float64).reshape(-1)
    if len(D) not in (4, 5, 8):
        raise NotImplementedError(f"{len(D)} distortion coefficients (4, 5 or 8 are supported)")
    k1, k2, p1, p2, k3, k4, k5, k6 = np.concatenate([D, np.zeros(8 - len(D))])
    R = np.eye(3) if R is None else np.asarray(R, np.float64)
    P = K if P is None else np.asarray(P, np.float64)[:3, :3]
    ir = np.linalg.inv(P @ R)
    j, i = np.meshgrid(np.arange(w, dtype=np.float64), np.arange(h, dtype=np.float64))
    _x = i * ir[0, 1] + ir[0, 2] + j * ir[0, 0]
    _y = i * ir[1, 1] + ir[1, 2] + j * ir[1, 0]
    _w = i * ir[2, 1] + ir[2, 2] + j * ir[2, 0]
    iw = 1.0 / _w
    x, y = _x * iw, _y * iw
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = (1 + ((k3 * r2 + k2) * r2 + k1) * r2) / (1 + ((k6 * r2 + k5) * r2 + k4) * r2)
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2
    return K[0, 0] * xd + K[0, 2], K[1, 1] * yd + K[1, 2]


def init_undistort_rectify_map(K, D, R, P, size):
    """``cv2.initUndistortRectifyMap(K, D, R, P, size, cv2.CV_32F)``: the
    float32 maps (map_x, map_y), each [h, w]; size is (w, h).  Computed in
    float64, as OpenCV does."""
    mx, my = _undistort_rectify_map64(K, D, R, P, size)
    return mx.astype(np.float32), my.astype(np.float32)


_TAB = 32               # OpenCV's INTER_TAB_SIZE: fixed-point maps in 1/32 pixel
_REMAP_SCALE = 32768    # INTER_REMAP_COEF_SCALE (15-bit weights)


class Remap:
    """``cv2.remap`` with INTER_LINEAR and a constant zero border, for a
    fixed pair of maps: the gather indices and weights are built once, here,
    and each call only gathers and blends.  Taps off the image read 0.

    Float maps (``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR)``): OpenCV
    blends in float32 with fused multiply-adds, along x and then along y,
    from the fractions of the float32 coordinates, and rounds to nearest.
    Each multiply-add here is exact in float64 and then rounded once to
    float32, as the fused one is.

    fixed_point (the CV_16SC2 maps ``cv2.undistort`` makes from float64
    ones): each coordinate is rounded to 1/32 pixel, the four taps take the
    15-bit weights of that fraction (they sum to 32768), and the blend rounds
    ``(sum + 2**14) >> 15``.
    """

    def __init__(self, map_x, map_y, src_size, fixed_point=False):
        w, h = src_size
        self.src_size, self.shape, self.fixed_point = (w, h), map_x.shape, fixed_point
        if fixed_point:
            X = np.rint(np.asarray(map_x) * _TAB).clip(-2**30, 2**30).astype(np.int64)
            Y = np.rint(np.asarray(map_y) * _TAB).clip(-2**30, 2**30).astype(np.int64)
            fx, fy = X & (_TAB - 1), Y & (_TAB - 1)
            sx, sy = X >> 5, Y >> 5
            self.wts = [wk.ravel().astype(np.int32) * 32 for wk in (
                (_TAB - fy) * (_TAB - fx), (_TAB - fy) * fx, fy * (_TAB - fx), fy * fx)]
        else:
            map_x = np.asarray(map_x, np.float32)
            map_y = np.asarray(map_y, np.float32)
            sx = np.floor(map_x).clip(-2**30, 2**30).astype(np.int64)
            sy = np.floor(map_y).clip(-2**30, 2**30).astype(np.int64)
            self.wts = [(map_x - sx.astype(np.float32)).astype(np.float64).ravel(),
                        (map_y - sy.astype(np.float32)).astype(np.float64).ravel()]
        # pixel indices into the image padded by one zero pixel on each side:
        # a tap off the image, however far, is clamped onto the padding
        wp = w + 2
        px0, px1 = np.clip(sx + 1, 0, w + 1), np.clip(sx + 2, 0, w + 1)
        py0, py1 = np.clip(sy + 1, 0, h + 1), np.clip(sy + 2, 0, h + 1)
        self.idx = np.stack([py0 * wp + px0, py0 * wp + px1,
                             py1 * wp + px0, py1 * wp + px1]).reshape(4, -1)
        self._by_channels = {}

    def _tables(self, c):
        """Element indices and weights for images of c channels."""
        if c not in self._by_channels:
            idx = (self.idx[:, :, None] * c + np.arange(c)).reshape(4, -1)
            self._by_channels[c] = (idx, [np.repeat(wk, c) for wk in self.wts])
        return self._by_channels[c]

    def __call__(self, img):
        img = np.asarray(img)
        if img.dtype != np.uint8:
            raise NotImplementedError(f"remap of {img.dtype} images")
        h, w = img.shape[:2]
        if (w, h) != self.src_size:
            raise ValueError(f"image is {w}x{h}, the maps were built for "
                             f"{self.src_size[0]}x{self.src_size[1]}")
        tail = img.shape[2:]
        padded = np.zeros((h + 2, w + 2) + tail, np.uint8)
        padded[1:-1, 1:-1] = img
        idx, wts = self._tables(int(np.prod(tail)))
        if self.fixed_point:
            acc = sum(np.take(padded, idx[k]) * wts[k] for k in range(4))
            out = (acc + (_REMAP_SCALE >> 1)) >> 15
        else:
            p00, p01, p10, p11 = (np.take(padded, i).astype(np.float64) for i in idx)
            alpha, beta = wts
            top = ((p01 - p00) * alpha + p00).astype(np.float32)
            bottom = ((p11 - p10) * alpha + p10).astype(np.float32)
            out = np.rint(((bottom - top) * beta + top).astype(np.float32))
        return out.astype(np.uint8).reshape(self.shape + tail)


def remap(img, map_x, map_y):
    """``cv2.remap(img, map_x, map_y, cv2.INTER_LINEAR)`` (constant zero
    border) for one image; a reader that remaps every frame with the same
    maps builds a ``Remap`` once instead."""
    img = np.asarray(img)
    return Remap(map_x, map_y, (img.shape[1], img.shape[0]))(img)


def undistort_remap(K, D, size):
    """The ``Remap`` that ``cv2.undistort(img, K, D)`` applies to a (w, h)
    image: the map with R = I and P = K, computed in float64 and rounded to
    OpenCV's fixed point."""
    mx, my = _undistort_rectify_map64(K, D, None, None, size)
    return Remap(mx, my, size, fixed_point=True)


def undistort(img, K, D):
    """``cv2.undistort(img, K, D)``."""
    img = np.asarray(img)
    return undistort_remap(K, D, (img.shape[1], img.shape[0]))(img)

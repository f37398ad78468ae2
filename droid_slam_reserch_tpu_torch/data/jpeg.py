"""JPEG decoding in numpy: what ``cv2.imread`` gives for a JPEG.

OpenCV decodes JPEGs with libjpeg-turbo at its defaults, and this module
repeats that library's arithmetic, so that the result equals cv2's:

- markers SOI, APPn (JFIF and Adobe), COM, DQT, SOF0/SOF1 (baseline and
  extended sequential), SOF2 (progressive), SOF9 and SOF10 (arithmetic-coded
  sequential and progressive), DHT, DAC, SOS, DRI with RSTn, EOI;
  interleaved and single-component scans;
- Huffman decoding (a 16-bit lookup table per code table), DC prediction
  reset at each restart marker;
- progressive scans as jdphuff.c decodes them: spectral selection and
  successive approximation, DC first and refine scans (interleaved or
  not), AC first scans with end-of-band runs, AC refine scans (correction
  bits, ZRL and EOBRUN as decode_mcu_AC_refine), restart intervals that
  reset the end-of-band run and the DC prediction; every scan's
  coefficients are gathered before the blocks are transformed;
- arithmetic decoding as jdarith.c does it: the QM decoder and jaricom.c's
  113-state table, DC statistics conditioned by the DAC marker's L and U
  (defaults 0 and 1), AC statistics split at Kx (default 5), sequential and
  progressive scans, statistics and decoder reset at each restart, zero
  bytes fed after a marker;
- dequantisation and the integer "islow" IDCT (jidctint.c: 13-bit
  constants, 2 extra bits after the column pass, the post-IDCT range-limit
  table);
- chroma at 4:4:4, 4:2:2 (h2v1), 4:2:0 (h2v2) and 4:4:0 (h1v2) by
  libjpeg's "fancy" triangular upsampling (jdsample.c), other integer
  ratios by replication, as libjpeg-turbo does;
- YCbCr -> BGR with jdcolor.c's 16-bit fixed-point tables; grey.

Lossless, hierarchical, 12-bit and 4-component (CMYK, YCCK) JPEGs raise
NotImplementedError naming the mode, and so does a progressive JPEG whose
scans leave bits of its first AC coefficients unknown: libjpeg smooths such
blocks (jdcoefct.c's decompress_smooth_data), which is not ported.
"""
import numpy as np

# zigzag order -> natural (row-major) index of the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# SOF markers decoded: (progressive, arithmetic)
_SOF_MODES = {0xC0: (False, False), 0xC1: (False, False), 0xC2: (True, False),
              0xC9: (False, True), 0xCA: (True, True)}
_UNSUPPORTED_SOF = {
    0xC3: "lossless", 0xC5: "differential sequential (hierarchical)",
    0xC6: "differential progressive (hierarchical)", 0xC7: "differential lossless (hierarchical)",
    0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential (hierarchical)",
    0xCE: "arithmetic-coded differential progressive (hierarchical)",
    0xCF: "arithmetic-coded differential lossless (hierarchical)",
}


# jaricom.c (ITU-T T.81 Table D.2): per state, Qe, the next state after an
# LPS, the next state after an MPS, and whether an LPS switches the MPS;
# state 113 is the fixed probability 0.5 (sign and DC refinement bits)
_ARITAB = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0), (0x080b, 18, 4, 0),
    (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0), (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0),
    (0x0036, 30, 9, 0), (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1), (0x3f25, 36, 16, 0),
    (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0), (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0),
    (0x0cef, 43, 21, 0), (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0), (0x01b1, 54, 28, 0),
    (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0), (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0),
    (0x0068, 62, 33, 0), (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0), (0x2ef1, 67, 40, 0),
    (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0), (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0),
    (0x1177, 73, 45, 0), (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0), (0x04de, 50, 52, 0),
    (0x040f, 50, 53, 0), (0x0363, 51, 54, 0), (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0),
    (0x01f8, 54, 57, 0), (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0), (0x008f, 61, 32, 0),
    (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0), (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0),
    (0x2fe8, 83, 69, 0), (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0), (0x119c, 74, 76, 0),
    (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0), (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0),
    (0x5832, 80, 81, 1), (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0), (0x2516, 86, 71, 0),
    (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0), (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0),
    (0x3824, 99, 93, 0), (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0), (0x3c3d, 104, 100, 0),
    (0x375e, 99, 93, 0), (0x5231, 105, 102, 0), (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0),
    (0x415e, 103, 99, 0), (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1), (0x5522, 112, 109, 0),
    (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0),
]
_QE = [q for q, _, _, _ in _ARITAB]
_NEXT_LPS = [nl | (sw << 7) for _, nl, _, sw in _ARITAB]     # the MPS switch in bit 7
_NEXT_MPS = [nm for _, _, nm, _ in _ARITAB]
_FIXED_STATE = 113
_DC_STAT_BINS, _AC_STAT_BINS = 64, 256


class _Component:
    def __init__(self, cid, h, v, tq):
        self.id, self.h, self.v, self.tq = cid, h, v, tq


def _huffman_lut(counts, symbols):
    """(length << 8 | symbol) for every 16-bit prefix of the canonical code
    of a DHT table; 0 where no code is a prefix (a corrupt stream)."""
    lut = np.zeros(1 << 16, np.int32)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            lo = code << (16 - length)
            lut[lo: lo + (1 << (16 - length))] = (length << 8) | symbols[k]
            code += 1
            k += 1
        code <<= 1
    return lut.tolist()


def _next_segment(blob, pos, path):
    """(marker, body, offset past the segment) of the marker segment at
    `pos` (fill bytes skipped; SOI, TEM and RSTn have no body)."""
    if pos >= len(blob) or blob[pos] != 0xFF:
        raise ValueError(f"{path}: corrupt JPEG (expected a marker at byte {pos})")
    while pos < len(blob) and blob[pos] == 0xFF:
        pos += 1
    if pos >= len(blob):
        raise ValueError(f"{path}: corrupt JPEG (ends inside a marker)")
    marker = blob[pos]
    pos += 1
    if marker in (0xD8, 0xD9, 0x01) or 0xD0 <= marker <= 0xD7:
        return marker, b"", pos
    n = (blob[pos] << 8) | blob[pos + 1]
    return marker, blob[pos + 2: pos + n], pos + n


def _entropy_data(blob, pos):
    """The entropy-coded bytes of a scan from `pos`: a list of restart
    intervals (byte stuffing removed) and the offset of the marker that
    ends the scan."""
    intervals, start, i, n = [], pos, pos, len(blob)
    while True:
        i = blob.find(b"\xff", i)
        if i < 0 or i + 1 >= n:
            intervals.append(blob[start:].replace(b"\xff\x00", b"\xff"))
            return intervals, n
        nxt = blob[i + 1]
        if nxt == 0x00 or nxt == 0xFF:
            i += 1
            continue
        if 0xD0 <= nxt <= 0xD7:
            intervals.append(blob[start:i].replace(b"\xff\x00", b"\xff"))
            start = i = i + 2
            continue
        intervals.append(blob[start:i].replace(b"\xff\x00", b"\xff"))
        return intervals, i


def _decode_interval(data, units, preds, m0, n_mcu):
    """Huffman-decode MCUs m0 .. m0 + n_mcu - 1, one restart interval.

    units: per block of the MCU, (component index, dc lut, ac lut, the
    block row of each MCU in the component's grid, the component's index
    and value lists, to which the nonzero coefficients are appended);
    preds: the DC predictors, reset by the caller."""
    words = _words(data)
    acc, nb, wi = 0, 0, 0
    zz = ZIGZAG.tolist()
    for mcu in range(m0, m0 + n_mcu):
        for ci, dc_lut, ac_lut, rows, out_idx, out_val in units:
            base = rows[mcu] * 64
            if nb < 32:
                acc = ((acc & ((1 << nb) - 1)) << 32) | (words[wi] if wi < len(words) else 0)
                wi += 1
                nb += 32
            e = dc_lut[(acc >> (nb - 16)) & 0xFFFF]
            if not e:
                raise ValueError("corrupt JPEG: bad Huffman code")
            nb -= e >> 8
            s = e & 0xFF
            diff = 0
            if s:
                diff = (acc >> (nb - s)) & ((1 << s) - 1)
                nb -= s
                if diff < (1 << (s - 1)):
                    diff -= (1 << s) - 1
            dc = preds[ci] + diff
            preds[ci] = dc
            if dc:
                out_idx.append(base)
                out_val.append(dc)
            k = 1
            while k < 64:
                if nb < 32:
                    acc = ((acc & ((1 << nb) - 1)) << 32) | (words[wi] if wi < len(words)
                                                             else 0)
                    wi += 1
                    nb += 32
                e = ac_lut[(acc >> (nb - 16)) & 0xFFFF]
                if not e:
                    raise ValueError("corrupt JPEG: bad Huffman code")
                nb -= e >> 8
                rs = e & 0xFF
                s = rs & 15
                if s:
                    k += rs >> 4
                    v = (acc >> (nb - s)) & ((1 << s) - 1)
                    nb -= s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    if k < 64:
                        out_idx.append(base + zz[k])
                        out_val.append(v)
                    k += 1
                elif rs == 0xF0:
                    k += 16
                else:
                    break


# jidctint.c's constants: FIX(x) = round(x * 2**13)
_C = {"0_298631336": 2446, "0_390180644": 3196, "0_541196100": 4433, "0_765366865": 6270,
      "0_899976223": 7373, "1_175875602": 9633, "1_501321110": 12299, "1_847759065": 15137,
      "1_961570560": 16069, "2_053119869": 16819, "2_562915447": 20995, "3_072711026": 25172}
CONST_BITS, PASS1_BITS = 13, 2


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_pass(d, shift):
    """One 1-D pass of jpeg_idct_islow over axis -1 of int64 d [..., 8]
    (coefficients 0..7); returns the 8 outputs descaled by `shift`."""
    c = _C
    z2, z3 = d[..., 2], d[..., 6]
    z1 = (z2 + z3) * c["0_541196100"]
    tmp2 = z1 + z3 * -c["1_847759065"]
    tmp3 = z1 + z2 * c["0_765366865"]
    tmp0 = (d[..., 0] + d[..., 4]) << CONST_BITS
    tmp1 = (d[..., 0] - d[..., 4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2

    tmp0, tmp1, tmp2, tmp3 = d[..., 7], d[..., 5], d[..., 3], d[..., 1]
    z1, z2, z3, z4 = tmp0 + tmp3, tmp1 + tmp2, tmp0 + tmp2, tmp1 + tmp3
    z5 = (z3 + z4) * c["1_175875602"]
    tmp0 = tmp0 * c["0_298631336"]
    tmp1 = tmp1 * c["2_053119869"]
    tmp2 = tmp2 * c["3_072711026"]
    tmp3 = tmp3 * c["1_501321110"]
    z1 = z1 * -c["0_899976223"]
    z2 = z2 * -c["2_562915447"]
    z3 = z3 * -c["1_961570560"] + z5
    z4 = z4 * -c["0_390180644"] + z5
    tmp0 = tmp0 + z1 + z3
    tmp1 = tmp1 + z2 + z4
    tmp2 = tmp2 + z2 + z3
    tmp3 = tmp3 + z1 + z4
    return np.stack([_descale(tmp10 + tmp3, shift), _descale(tmp11 + tmp2, shift),
                     _descale(tmp12 + tmp1, shift), _descale(tmp13 + tmp0, shift),
                     _descale(tmp13 - tmp0, shift), _descale(tmp12 - tmp1, shift),
                     _descale(tmp11 - tmp2, shift), _descale(tmp10 - tmp3, shift)], axis=-1)


def _post_idct_table():
    """jdmaster.c's range-limit table as the IDCT indexes it (x & 1023):
    x + 128 clamped to [0, 255] for x in [-512, 511]."""
    x = np.arange(1024)
    x = np.where(x >= 512, x - 1024, x)
    return np.clip(x + 128, 0, 255).astype(np.uint8)


_RANGE = _post_idct_table()


def idct_islow(coefs, qtable):
    """jpeg_idct_islow: coefs [N, 64] natural-order int coefficients, qtable
    [64] natural order -> samples [N, 8, 8] uint8."""
    d = (coefs.astype(np.int64) * qtable.astype(np.int64)).reshape(-1, 8, 8)
    # pass 1: columns (over rows of the transposed block), 2 extra bits kept
    ws = _idct_pass(np.swapaxes(d, 1, 2), CONST_BITS - PASS1_BITS)     # [N, col, row]
    ws = np.swapaxes(ws, 1, 2)                                          # [N, row, col]
    out = _idct_pass(ws, CONST_BITS + PASS1_BITS + 3)
    return _RANGE[out & 1023]


def _fancy_h(x, width):
    """h2v1_fancy_upsample over axis 1 of x [H, W] (int32) cut to `width`
    real columns: 3/4 of the nearer sample, 1/4 of the further, edge
    samples repeated."""
    x = x[:, :width]
    left = np.concatenate([x[:, :1], x[:, :-1]], 1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], 1)
    out = np.empty((x.shape[0], 2 * width), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    out[:, 0] = x[:, 0]
    out[:, -1] = x[:, -1]
    return out


def _fancy_v(x, height):
    """h1v2_fancy_upsample over axis 0 (rows above and below the real
    `height` rows repeat the edge rows)."""
    x = x[:height]
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * height, x.shape[1]), np.int32)
    out[0::2] = (3 * x + up + 1) >> 2
    out[1::2] = (3 * x + down + 2) >> 2
    return out


def _fancy_hv(x, height, width):
    """h2v2_fancy_upsample: a vertical 3:1 column sum with the nearer row
    (edge rows repeated), then 3:1 along the row with +8 / +7 rounding."""
    x = x[:height, :width]
    up = np.concatenate([x[:1], x[:-1]], 0)
    down = np.concatenate([x[1:], x[-1:]], 0)
    out = np.empty((2 * height, 2 * width), np.int32)
    for r, near in ((0, up), (1, down)):
        col = 3 * x + near                                 # thiscolsum
        last = np.concatenate([col[:, :1], col[:, :-1]], 1)
        nxt = np.concatenate([col[:, 1:], col[:, -1:]], 1)
        rows = out[r::2]
        rows[:, 0::2] = (3 * col + last + 8) >> 4
        rows[:, 1::2] = (3 * col + nxt + 7) >> 4
        rows[:, 0] = (4 * col[:, 0] + 8) >> 4
        rows[:, -1] = (4 * col[:, -1] + 7) >> 4
    return out


def _upsample(plane, comp, hmax, vmax, width, height):
    """A component's samples at full resolution (jdsample.c's choice of
    method, with fancy upsampling on, as OpenCV leaves it)."""
    fh, fv = hmax // comp.h, vmax // comp.v
    if hmax % comp.h or vmax % comp.v:
        raise NotImplementedError(f"JPEG sampling factors {comp.h}x{comp.v} of {hmax}x{vmax}")
    cw = -(-width * comp.h // hmax)                         # downsampled width, height
    ch = -(-height * comp.v // vmax)
    x = plane.astype(np.int32)
    if (fh, fv) == (1, 1):
        out = x
    elif (fh, fv) == (2, 1) and cw > 2:
        out = _fancy_h(x, cw)
    elif (fh, fv) == (1, 2):
        out = _fancy_v(x, ch)
    elif (fh, fv) == (2, 2) and cw > 2:
        out = _fancy_hv(x, ch, cw)
    else:                                                   # box replication
        out = np.repeat(np.repeat(x, fv, 0), fh, 1)
    return out[:height, :width]


def _ycc_tables():
    """jdcolor.c's build_ycc_rgb_table (SCALEBITS 16)."""
    x = np.arange(256, dtype=np.int64) - 128
    one_half = 1 << 15

    def fix(v):
        return int(v * (1 << 16) + 0.5)

    return ((fix(1.40200) * x + one_half) >> 16, (fix(1.77200) * x + one_half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + one_half)


_CR_R, _CB_B, _CR_G, _CB_G = _ycc_tables()


def ycc_to_bgr(y, cb, cr):
    """ycc_rgb_convert with the sample range limit: [H, W] int planes ->
    [H, W, 3] uint8 BGR."""
    y = y.astype(np.int64)
    r = y + _CR_R[cr]
    g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
    b = y + _CB_B[cb]
    return np.clip(np.stack([b, g, r], -1), 0, 255).astype(np.uint8)


class Coefficients:
    """A JPEG's frame and its quantised coefficients, as libjpeg's
    jpeg_read_coefficients gives them: ``comps`` (id, h, v, quantisation
    table number ``tq``, the latched table ``q`` [64] in natural order, and
    ``blocks`` [bh * bw, 64] int32 in natural order over the MCU-padded
    block grid ``bh`` x ``bw``), the frame's width, height, hmax, vmax, MCU
    columns and rows, and the JFIF and Adobe markers that pick the colour
    transform."""

    def __init__(self, comps, frame, jfif, adobe_transform):
        self.comps = comps
        self.width, self.height, self.hmax, self.vmax, self.mcux, self.mcuy = frame
        self.jfif, self.adobe_transform = jfif, adobe_transform


def decode(blob, path="<bytes>"):
    """Decode a JPEG: [H, W, 1] uint8 for grey, else [H, W, 3] BGR, as
    cv2.imread returns it before grey is replicated."""
    return render(read_coefficients(blob, path))


def render(coefs):
    """Samples of read_coefficients' result: the islow IDCT, fancy
    upsampling and the colour transform, as libjpeg's output pass."""
    planes = []
    for c in coefs.comps:
        px = idct_islow(c.blocks, c.q)                                  # [bh * bw, 8, 8]
        plane = px.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        planes.append(_upsample(plane, c, coefs.hmax, coefs.vmax, coefs.width, coefs.height))
    if len(coefs.comps) == 1:
        return planes[0].astype(np.uint8)[..., None]
    ids = tuple(c.id for c in coefs.comps)
    adobe, jfif = coefs.adobe_transform, coefs.jfif
    rgb = (adobe == 0 if adobe is not None and not jfif
           else (not jfif and ids == (82, 71, 66)))
    if rgb:
        return np.stack(planes[::-1], -1).astype(np.uint8)
    return ycc_to_bgr(*planes)


def read_coefficients(blob, path="<bytes>"):
    """Parse a JPEG and decode every scan: a Coefficients."""
    qt, dc_tabs, ac_tabs = {}, {}, {}
    comps, frame, restart, mode = None, None, 0, None
    jfif = adobe_transform = None
    dac_l, dac_u, dac_k = [0] * 16, [1] * 16, [5] * 16        # jdmarker.c's defaults
    if blob[:2] != b"\xff\xd8":
        raise ValueError(f"{path}: not a JPEG file (no SOI marker)")
    pos = 2
    while True:
        marker, body, pos = _next_segment(blob, pos, path)
        if marker == 0xE0 and body[:5] == b"JFIF\x00":
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe_transform = body[11]
        elif marker == 0xDB:
            i = 0
            while i < len(body):
                pq, tq = body[i] >> 4, body[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(body[i + 1: i + 1 + n], ">u2" if pq else np.uint8)
                table = np.zeros(64, np.int64)
                table[ZIGZAG] = vals
                qt[tq] = table
                i += 1 + n
        elif marker in _SOF_MODES:
            mode = _SOF_MODES[marker]
            precision = body[0]
            if precision != 8:
                raise NotImplementedError(f"{path}: {precision}-bit JPEG samples "
                                          f"(8-bit only)")
            height, width, nc = (body[1] << 8) | body[2], (body[3] << 8) | body[4], body[5]
            if height == 0:
                raise NotImplementedError(f"{path}: JPEG height given by a DNL marker")
            if nc not in (1, 3):
                raise NotImplementedError(f"{path}: {nc}-component JPEG (CMYK/YCCK)")
            comps = [_Component(body[6 + 3 * k], body[7 + 3 * k] >> 4, body[7 + 3 * k] & 15,
                                body[8 + 3 * k]) for k in range(nc)]
            hmax, vmax = max(c.h for c in comps), max(c.v for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c.bw, c.bh = mcux * c.h, mcuy * c.v              # blocks, MCU-padded
                c.idx, c.val, c.q = [], [], None
                if mode[0]:                                        # zigzag order
                    c.coef = np.zeros((c.bh * c.bw, 64), np.int32)
                    c.coef_bits = [-1] * 64
            frame = (width, height, hmax, vmax, mcux, mcuy)
        elif marker in _UNSUPPORTED_SOF:
            raise NotImplementedError(f"{path}: {_UNSUPPORTED_SOF[marker]} JPEG is not "
                                      f"supported")
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1: i + 17])
                n = sum(counts)
                lut = _huffman_lut(counts, list(body[i + 17: i + 17 + n]))
                (ac_tabs if tc else dc_tabs)[th] = lut
                i += 17 + n
        elif marker == 0xCC:
            for i in range(0, len(body) - 1, 2):
                tc, tb, val = body[i] >> 4, body[i] & 15, body[i + 1]
                if tc:
                    dac_k[tb] = val
                else:
                    dac_l[tb], dac_u[tb] = val & 15, val >> 4
                    if dac_l[tb] > dac_u[tb]:
                        raise ValueError(f"{path}: corrupt JPEG (DAC L {dac_l[tb]} > U "
                                         f"{dac_u[tb]})")
        elif marker == 0xDD:
            restart = (body[0] << 8) | body[1]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: corrupt JPEG (SOS before SOF)")
            ns = body[0]
            cis, tds, tas = [], [], []
            for k in range(ns):
                cid, tables = body[1 + 2 * k], body[2 + 2 * k]
                ci = next(i for i, c in enumerate(comps) if c.id == cid)
                cis.append(ci)
                tds.append(tables >> 4)
                tas.append(tables & 15)
                if comps[ci].q is None:                 # latched at the first scan, as libjpeg
                    if comps[ci].tq not in qt:
                        raise ValueError(f"{path}: quantisation table {comps[ci].tq} is "
                                         f"missing")
                    comps[ci].q = qt[comps[ci].tq].copy()
            ss, se, ah, al = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns] >> 4, \
                body[3 + 2 * ns] & 15
            progressive, arithmetic = mode
            if progressive:
                _check_progressive_scan(path, ns, ss, se, ah, al)
                for ci in cis:
                    bits = comps[ci].coef_bits
                    bits[ss: se + 1] = [al] * (se + 1 - ss)
            elif ss != 0 or se != 63 or ah or al:
                raise NotImplementedError(f"{path}: a sequential JPEG with a spectral or "
                                          f"successive-approximation scan is not supported")
            if not progressive and not arithmetic:
                scan = [(ci, dc_tabs[td], ac_tabs[ta]) for ci, td, ta in zip(cis, tds, tas)]
                pos = _decode_scan(blob, pos, frame, comps, scan, restart)
            else:
                intervals, pos = _entropy_data(blob, pos)
                n_mcu, units = _scan_units(frame, comps, cis)
                if arithmetic:
                    tables = [(td, ta, dac_l[td], dac_u[td], dac_k[ta])
                              for td, ta in zip(tds, tas)]
                    _arith_scan(path, intervals, n_mcu, units, comps, cis, tables, restart,
                                progressive, ss, se, ah, al)
                else:
                    luts = [(dc_tabs.get(td), ac_tabs.get(ta)) for td, ta in zip(tds, tas)]
                    _progressive_huffman_scan(path, intervals, n_mcu, units, comps, cis, luts,
                                              restart, ss, se, ah, al)
            if pos >= len(blob):
                break                  # no EOI: libjpeg accepts a truncated end
        elif marker == 0xD9:
            break
    if frame is None:
        raise ValueError(f"{path}: no frame header (SOF) in the JPEG")
    for c in comps:
        if c.q is None:                        # in no scan: its blocks stay 0
            if c.tq not in qt:
                raise ValueError(f"{path}: quantisation table {c.tq} is missing")
            c.q = qt[c.tq].copy()
        if mode[0]:
            c.blocks = np.zeros((c.bh * c.bw, 64), np.int32)
            c.blocks[:, ZIGZAG] = c.coef
        else:
            blocks = np.zeros(c.bh * c.bw * 64, np.int32)
            blocks[np.asarray(c.idx, np.int64)] = c.val
            c.blocks = blocks.reshape(-1, 64)
    if mode[0] and _smoothing_applies(comps):
        raise NotImplementedError(
            f"{path}: a progressive JPEG whose scans leave bits of its first AC coefficients "
            f"unknown (libjpeg's block smoothing of an incomplete image is not supported)")
    return Coefficients(comps, frame, jfif, adobe_transform)


def _check_progressive_scan(path, ns, ss, se, ah, al):
    """jdphuff.c / jdarith.c start_pass: the scan parameters a progressive
    scan may have."""
    if (ss == 0 and se != 0) or (ss and (se < ss or se > 63 or ns != 1)) \
            or (ah and ah - 1 != al) or al > 13:
        raise ValueError(f"{path}: corrupt JPEG (progressive scan Ss={ss} Se={se} Ah={ah} "
                         f"Al={al} over {ns} components)")


def _smoothing_applies(comps):
    """jdcoefct.c's smoothing_ok (libjpeg-turbo, coefficients 0-9) after the
    last scan: every component's DC partly known, its table's first ten
    quantisers nonzero, and some AC coefficient 1-9 of some component not
    known to its last bit."""
    useful = False
    for c in comps:
        if c.coef_bits[0] < 0 or not np.all(c.q[ZIGZAG[:10]]):
            return False
        useful |= any(b != 0 for b in c.coef_bits[1:10])
    return useful


def _scan_units(frame, comps, cis):
    """(MCUs in the scan, [(component index, block rows [n_mcu] into its
    coefficient array) for each block of an MCU]): an interleaved scan's
    MCUs, or a single component's own block grid (its samples' width and
    height in blocks, not MCU-padded), row by row."""
    width, height, hmax, vmax, mcux, mcuy = frame
    if len(cis) == 1:
        c = comps[cis[0]]
        bw = -(-(-(-width * c.h // hmax)) // 8)
        bh = -(-(-(-height * c.v // vmax)) // 8)
        u = np.arange(bw * bh)
        return bw * bh, [(cis[0], (u // bw) * c.bw + u % bw)]
    m = np.arange(mcux * mcuy)
    units = []
    for ci in cis:
        c = comps[ci]
        for v in range(c.v):
            for h in range(c.h):
                units.append((ci, ((m // mcux) * c.v + v) * c.bw + (m % mcux) * c.h + h))
    return mcux * mcuy, units


def _intervals(intervals, n_mcu, restart):
    """(bytes, first MCU, MCUs) of each restart interval of a scan."""
    per = restart or n_mcu
    done = 0
    for data in intervals:
        if done >= n_mcu:
            break
        n = min(per, n_mcu - done)
        yield data, done, n
        done += n


def _words(data):
    return np.frombuffer(data + b"\x00" * (8 - len(data) % 4), ">u4").tolist()


def _progressive_huffman_scan(path, intervals, n_mcu, units, comps, cis, luts, restart,
                              ss, se, ah, al):
    """One progressive Huffman scan (jdphuff.c), into the components'
    zigzag-order coefficient arrays."""
    if ss == 0 and ah:                        # DC refine: the next bit of each block's DC
        for data, m0, n in _intervals(intervals, n_mcu, restart):
            bits = np.unpackbits(np.frombuffer(data, np.uint8))
            bits = np.concatenate([bits, np.zeros(max(0, n * len(units) - len(bits)), np.uint8)])
            bits = bits[: n * len(units)].reshape(n, len(units))
            for u, (ci, rows) in enumerate(units):
                comps[ci].coef[rows[m0: m0 + n], 0] |= bits[:, u].astype(np.int32) << al
        return
    if ss == 0:                               # DC first, interleaved or not
        rows_out, vals_out = [[] for _ in comps], [[] for _ in comps]
        plan = []
        for (ci, rows) in units:
            lut = luts[cis.index(ci)][0]
            if lut is None:
                raise ValueError(f"{path}: corrupt JPEG (DC scan without a DC Huffman table)")
            plan.append((ci, lut, rows.tolist(), rows_out[ci], vals_out[ci]))
        for data, m0, n in _intervals(intervals, n_mcu, restart):
            words = _words(data)
            acc = nb = wi = 0
            preds = [0] * len(comps)
            for m in range(m0, m0 + n):
                for ci, lut, rows, ro, vo in plan:
                    if nb < 32:
                        acc = ((acc & ((1 << nb) - 1)) << 32) | (words[wi] if wi < len(words)
                                                                 else 0)
                        wi += 1
                        nb += 32
                    e = lut[(acc >> (nb - 16)) & 0xFFFF]
                    if not e:
                        raise ValueError(f"{path}: corrupt JPEG (bad Huffman code)")
                    nb -= e >> 8
                    s = e & 0xFF
                    if s:
                        diff = (acc >> (nb - s)) & ((1 << s) - 1)
                        nb -= s
                        if diff < (1 << (s - 1)):
                            diff -= (1 << s) - 1
                        preds[ci] += diff
                    ro.append(rows[m])
                    vo.append(preds[ci])
        for ci in set(cis):
            comps[ci].coef[np.asarray(rows_out[ci], np.int64), 0] = \
                np.asarray(vals_out[ci], np.int64) << al
        return
    (ci, rows), = units
    lut = luts[0][1]
    if lut is None:
        raise ValueError(f"{path}: corrupt JPEG (AC scan without an AC Huffman table)")
    coef = comps[ci].coef
    flat = coef.reshape(-1)
    if ah == 0:
        _ac_first_huffman(path, intervals, n_mcu, restart, rows, lut, ss, se, al, flat)
    else:
        _ac_refine_huffman(path, intervals, n_mcu, restart, rows, lut, ss, se, al, coef)


def _ac_first_huffman(path, intervals, n_mcu, restart, rows, lut, ss, se, al, flat):
    """decode_mcu_AC_first: coefficients ss..se of one block per MCU, end-of-band runs."""
    idx, val = [], []
    rows = rows.tolist()
    for data, m0, n in _intervals(intervals, n_mcu, restart):
        words = _words(data)
        acc = nb = wi = 0
        eobrun = 0
        for u in range(m0, m0 + n):
            if eobrun:
                eobrun -= 1
                continue
            base = rows[u] * 64
            k = ss
            while k <= se:
                if nb < 32:
                    acc = ((acc & ((1 << nb) - 1)) << 32) | (words[wi] if wi < len(words) else 0)
                    wi += 1
                    nb += 32
                e = lut[(acc >> (nb - 16)) & 0xFFFF]
                if not e:
                    raise ValueError(f"{path}: corrupt JPEG (bad Huffman code)")
                nb -= e >> 8
                r, s = (e >> 4) & 15, e & 15
                if s:
                    k += r
                    v = (acc >> (nb - s)) & ((1 << s) - 1)
                    nb -= s
                    if v < (1 << (s - 1)):
                        v -= (1 << s) - 1
                    idx.append(base + min(k, 63))
                    val.append(v)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    eobrun = 1 << r
                    if r:
                        eobrun += (acc >> (nb - r)) & ((1 << r) - 1)
                        nb -= r
                    eobrun -= 1
                    break
    flat[np.asarray(idx, np.int64)] = np.asarray(val, np.int64) << al


def _ac_refine_huffman(path, intervals, n_mcu, restart, rows, lut, ss, se, al, coef):
    """decode_mcu_AC_refine: a correction bit for every coefficient of the
    band that earlier scans made nonzero, new coefficients of +-1 << al,
    ZRL and end-of-band runs.  The band's nonzero positions are taken
    before the scan (a block's new coefficients lie behind its cursor), and
    the corrections are applied after it, each as libjpeg applies it."""
    p1 = 1 << al
    nz_b, nz_k = np.nonzero(coef[rows, ss: se + 1])
    nz_k = (nz_k + ss).tolist()
    starts = np.searchsorted(nz_b, np.arange(len(rows) + 1)).tolist()
    rows = rows.tolist()
    corr, new_idx, new_val = [], [], []
    for data, m0, n in _intervals(intervals, n_mcu, restart):
        words = _words(data)
        acc = nb = wi = 0
        eobrun = 0
        for u in range(m0, m0 + n):
            base = rows[u] * 64
            pi, pe = starts[u], starts[u + 1]
            k = ss
            if eobrun == 0:
                while k <= se:
                    if nb < 32:
                        acc = ((acc & ((1 << nb) - 1)) << 32) | (words[wi] if wi < len(words)
                                                                 else 0)
                        wi += 1
                        nb += 32
                    e = lut[(acc >> (nb - 16)) & 0xFFFF]
                    if not e:
                        raise ValueError(f"{path}: corrupt JPEG (bad Huffman code)")
                    nb -= e >> 8
                    r, s = (e >> 4) & 15, e & 15
                    if s:
                        nb -= 1
                        s = p1 if (acc >> nb) & 1 else -p1
                    elif r != 15:
                        eobrun = 1 << r
                        if r:
                            eobrun += (acc >> (nb - r)) & ((1 << r) - 1)
                            nb -= r
                        break
                    # pass the band's nonzero coefficients (a correction bit
                    # each) and r zero ones; stop on the next zero one
                    while True:
                        p = nz_k[pi] if pi < pe else se + 1
                        if r < p - k:
                            k += r
                            break
                        r -= p - k
                        k = p
                        if k > se:
                            break
                        if nb < 32:
                            acc = ((acc & ((1 << nb) - 1)) << 32) | (words[wi] if wi < len(words)
                                                                     else 0)
                            wi += 1
                            nb += 32
                        nb -= 1
                        if (acc >> nb) & 1:
                            corr.append(base + k)
                        pi += 1
                        k += 1
                    if s:
                        new_idx.append(base + min(k, 63))
                        new_val.append(s)
                    k += 1
            if eobrun > 0:
                for q in range(pi, pe):
                    if nb < 32:
                        acc = ((acc & ((1 << nb) - 1)) << 32) | (words[wi] if wi < len(words)
                                                                 else 0)
                        wi += 1
                        nb += 32
                    nb -= 1
                    if (acc >> nb) & 1:
                        corr.append(base + nz_k[q])
                eobrun -= 1
    flat = coef.reshape(-1)
    corr = np.asarray(corr, np.int64)
    v = flat[corr]
    flat[corr] = np.where((v & p1) == 0, v + np.where(v >= 0, p1, -p1), v)
    flat[np.asarray(new_idx, np.int64)] = new_val


def _qm_decoder(data):
    """jdarith.c's arith_decode over one restart interval's bytes (byte
    stuffing removed; zero bytes after its end, as after a marker):
    decode(stats, i) decodes one binary decision with the state stats[i]
    and updates it."""
    n = len(data)
    qe_of, nl_of, nm_of = _QE, _NEXT_LPS, _NEXT_MPS
    c = a = pos = 0
    ct = -16

    def decode(st, i):
        nonlocal c, a, ct, pos
        while a < 0x8000:
            ct -= 1
            if ct < 0:
                c = (c << 8) | (data[pos] if pos < n else 0)
                pos += 1
                ct += 8
                if ct < 0:
                    ct += 1
                    if ct == 0:
                        a = 0x8000
            a <<= 1
        sv = st[i]
        j = sv & 0x7F
        qe = qe_of[j]
        a -= qe
        temp = a << ct
        if c >= temp:
            c -= temp
            if a < qe:
                st[i] = (sv & 0x80) ^ nm_of[j]
            else:
                st[i] = (sv & 0x80) ^ nl_of[j]
                sv ^= 0x80
            a = qe
        elif a < 0x8000:
            if a < qe:
                st[i] = (sv & 0x80) ^ nl_of[j]
                sv ^= 0x80
            else:
                st[i] = (sv & 0x80) ^ nm_of[j]
        return sv >> 7

    return decode


def _arith_dc_diff(path, dec, st, ctx, ci, lo, hi):
    """Figures F.19-F.24: one DC difference with the statistics st (a DC
    table's 64 bins); updates ctx[ci], the conditioning category."""
    s0 = ctx[ci]
    if dec(st, s0) == 0:
        ctx[ci] = 0
        return 0
    sign = dec(st, s0 + 1)
    i = s0 + 2 + sign
    m = dec(st, i)
    if m:
        i = 20
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                raise ValueError(f"{path}: corrupt arithmetic-coded JPEG (DC magnitude)")
            i += 1
    if m < (1 << lo) >> 1:
        ctx[ci] = 0
    elif m > (1 << hi) >> 1:
        ctx[ci] = 12 + 4 * sign
    else:
        ctx[ci] = 4 + 4 * sign
    v = m
    i += 14
    m >>= 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _arith_ac(path, dec, st, fixed, k, kx):
    """Figures F.21-F.24 after a nonzero decision at band position k: the
    coefficient's value."""
    i = 3 * (k - 1) + 2
    sign = dec(fixed, 0)
    m = dec(st, i)
    if m and dec(st, i):
        m <<= 1
        i = 189 if k <= kx else 217
        while dec(st, i):
            m <<= 1
            if m == 0x8000:
                raise ValueError(f"{path}: corrupt arithmetic-coded JPEG (AC magnitude)")
            i += 1
    v = m
    i += 14
    m >>= 1
    while m:
        if dec(st, i):
            v |= m
        m >>= 1
    v += 1
    return -v if sign else v


def _int16(v):
    """A JCOEF store: v wrapped to 16 bits, signed."""
    return ((v + 0x8000) & 0xFFFF) - 0x8000


def _arith_scan(path, intervals, n_mcu, units, comps, cis, tables, restart, progressive,
                ss, se, ah, al):
    """One arithmetic-coded scan (jdarith.c): decode_mcu for a sequential
    frame, into the components' coefficient lists; decode_mcu_DC_first,
    _AC_first, _DC_refine or _AC_refine for a progressive one, into their
    zigzag-order arrays.  The statistics of the scan's tables and the
    decoder start afresh in every restart interval."""
    plan = [(ci, rows.tolist(), tables[cis.index(ci)]) for ci, rows in units]
    fixed = [_FIXED_STATE]
    if progressive and ah and ss == 0:          # DC refine: one fixed-probability bit a block
        p1 = 1 << al
        for data, m0, n in _intervals(intervals, n_mcu, restart):
            dec = _qm_decoder(data)
            for m in range(m0, m0 + n):
                for ci, rows, _ in plan:
                    if dec(fixed, 0):
                        comps[ci].coef[rows[m], 0] |= p1
        return
    if progressive and ss:
        (ci, rows, (_, ta, _, _, kx)), = plan
        coef = comps[ci].coef
        (_arith_ac_refine if ah else _arith_ac_first)(path, intervals, n_mcu, restart, rows,
                                                      ss, se, al, kx, coef)
        return
    out_rows, out_vals = [[] for _ in comps], [[] for _ in comps]
    for data, m0, n in _intervals(intervals, n_mcu, restart):
        dec = _qm_decoder(data)
        dc_stats = {td: [0] * _DC_STAT_BINS for _, _, (td, _, _, _, _) in plan}
        ac_stats = {ta: [0] * _AC_STAT_BINS for _, _, (_, ta, _, _, _) in plan}
        last = [0] * len(comps)
        ctx = [0] * len(comps)
        for m in range(m0, m0 + n):
            for ci, rows, (td, ta, lo, hi, kx) in plan:
                diff = _arith_dc_diff(path, dec, dc_stats[td], ctx, ci, lo, hi)
                if progressive:                 # DC first
                    last[ci] += diff
                    out_rows[ci].append(rows[m])
                    out_vals[ci].append(_int16(last[ci] << al))
                    continue
                last[ci] = (last[ci] + diff) & 0xFFFF
                base = rows[m] * 64
                c = comps[ci]
                dc = _int16(last[ci])
                if dc:
                    c.idx.append(base)
                    c.val.append(dc)
                st = ac_stats[ta]
                k = 1
                while k <= 63:
                    i = 3 * (k - 1)
                    if dec(st, i):
                        break                    # end of block
                    while dec(st, i + 1) == 0:
                        i += 3
                        k += 1
                        if k > 63:
                            raise ValueError(f"{path}: corrupt arithmetic-coded JPEG "
                                             f"(spectral overflow)")
                    c.idx.append(base + int(ZIGZAG[k]))
                    c.val.append(_int16(_arith_ac(path, dec, st, fixed, k, kx)))
                    k += 1
    if progressive:
        for ci in set(cis):
            comps[ci].coef[np.asarray(out_rows[ci], np.int64), 0] = out_vals[ci]


def _arith_ac_first(path, intervals, n_mcu, restart, rows, ss, se, al, kx, coef):
    """decode_mcu_AC_first (arithmetic): coefficients ss..se of one block an MCU."""
    idx, val = [], []
    fixed = [_FIXED_STATE]
    for data, m0, n in _intervals(intervals, n_mcu, restart):
        dec = _qm_decoder(data)
        st = [0] * _AC_STAT_BINS
        for u in range(m0, m0 + n):
            base = rows[u] * 64
            k = ss
            while k <= se:
                i = 3 * (k - 1)
                if dec(st, i):
                    break
                while dec(st, i + 1) == 0:
                    i += 3
                    k += 1
                    if k > se:
                        raise ValueError(f"{path}: corrupt arithmetic-coded JPEG "
                                         f"(spectral overflow)")
                idx.append(base + k)
                val.append(_int16(_arith_ac(path, dec, st, fixed, k, kx) << al))
                k += 1
    coef.reshape(-1)[np.asarray(idx, np.int64)] = val


def _arith_ac_refine(path, intervals, n_mcu, restart, rows, ss, se, al, kx, coef):
    """decode_mcu_AC_refine (arithmetic): below the previous stage's last
    nonzero coefficient (EOBx) no end-of-block decision; a correction
    decision for each coefficient earlier scans made nonzero, a
    newly-nonzero decision and a sign for each other one."""
    p1 = 1 << al
    hist = coef[rows].tolist()
    nzm = coef[rows, 1: se + 1] != 0
    kexs = np.where(nzm.any(1), se - np.argmax(nzm[:, ::-1], 1), 0).tolist()
    fixed = [_FIXED_STATE]
    corr, new_idx, new_val = [], [], []
    for data, m0, n in _intervals(intervals, n_mcu, restart):
        dec = _qm_decoder(data)
        st = [0] * _AC_STAT_BINS
        for u in range(m0, m0 + n):
            base = rows[u] * 64
            h = hist[u]
            kex = kexs[u]
            k = ss
            while k <= se:
                i = 3 * (k - 1)
                if k > kex and dec(st, i):
                    break
                while True:
                    if h[k]:
                        if dec(st, i + 2):
                            corr.append(base + k)
                        break
                    if dec(st, i + 1):
                        new_idx.append(base + k)
                        new_val.append(-p1 if dec(fixed, 0) else p1)
                        break
                    i += 3
                    k += 1
                    if k > se:
                        raise ValueError(f"{path}: corrupt arithmetic-coded JPEG "
                                         f"(spectral overflow)")
                k += 1
    flat = coef.reshape(-1)
    corr = np.asarray(corr, np.int64)
    v = flat[corr]
    flat[corr] = v + np.where(v < 0, -p1, p1)
    flat[np.asarray(new_idx, np.int64)] = new_val


def _decode_scan(blob, pos, frame, comps, scan, restart):
    """Decode one sequential Huffman scan starting at `pos`; returns the
    offset of the marker after it.  Coefficients go to each component's
    idx/val lists (flat indices into its MCU-padded block grid)."""
    intervals, end = _entropy_data(blob, pos)
    cis = [ci for ci, _, _ in scan]
    n_mcu, units = _scan_units(frame, comps, cis)
    units = [(ci, *scan[cis.index(ci)][1:], rows.tolist(), comps[ci].idx, comps[ci].val)
             for ci, rows in units]
    for data, m0, n in _intervals(intervals, n_mcu, restart):
        _decode_interval(data, units, [0] * len(comps), m0, n)
    return end

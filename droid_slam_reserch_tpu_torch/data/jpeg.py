"""Baseline JPEG decoding in numpy: what ``cv2.imread`` gives for a JPEG.

OpenCV decodes JPEGs with libjpeg-turbo at its defaults, and this module
repeats that library's arithmetic, so that the result equals cv2's (the
tests hold it within 1 per channel):

- markers SOI, APPn (JFIF and Adobe), COM, DQT, SOF0/SOF1 (8-bit), DHT,
  SOS, DRI with RSTn, EOI; interleaved and single-component scans;
- Huffman decoding (a 16-bit lookup table per code table), DC prediction
  reset at each restart marker;
- dequantisation and the integer "islow" IDCT (jidctint.c: 13-bit
  constants, 2 extra bits after the column pass, the post-IDCT range-limit
  table);
- chroma at 4:4:4, 4:2:2 (h2v1), 4:2:0 (h2v2) and 4:4:0 (h1v2) by
  libjpeg's "fancy" triangular upsampling (jdsample.c), other integer
  ratios by replication, as libjpeg-turbo does;
- YCbCr -> BGR with jdcolor.c's 16-bit fixed-point tables; grey.

Progressive, arithmetic-coded, lossless, hierarchical, 12-bit and
4-component (CMYK, YCCK) JPEGs raise NotImplementedError naming the mode.
"""
import numpy as np

# zigzag order -> natural (row-major) index of the 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

_UNSUPPORTED_SOF = {
    0xC2: "progressive", 0xC3: "lossless", 0xC5: "differential sequential (hierarchical)",
    0xC6: "differential progressive (hierarchical)", 0xC7: "differential lossless (hierarchical)",
    0xC9: "arithmetic-coded sequential", 0xCA: "arithmetic-coded progressive",
    0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential (hierarchical)",
    0xCE: "arithmetic-coded differential progressive (hierarchical)",
    0xCF: "arithmetic-coded differential lossless (hierarchical)",
}


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


def _decode_interval(data, units, preds, n_mcu):
    """Huffman-decode `n_mcu` MCUs of one restart interval.

    units: per block of the MCU, (component index, dc lut, ac lut, block
    offset function of the MCU's number, the component's index and value
    lists, to which the nonzero coefficients are appended); preds: the DC
    predictors, reset by the caller."""
    words = np.frombuffer(data + b"\x00" * (8 - len(data) % 4), ">u4").tolist()
    acc, nb, wi = 0, 0, 0
    zz = ZIGZAG.tolist()
    for mcu in range(n_mcu):
        for ci, dc_lut, ac_lut, base_of, out_idx, out_val in units:
            base = base_of(mcu)
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


def decode(blob, path="<bytes>"):
    """Decode a baseline JPEG: [H, W, 1] uint8 for grey, else [H, W, 3]
    BGR, as cv2.imread returns it before grey is replicated."""
    qt, dc_tabs, ac_tabs = {}, {}, {}
    comps, frame, restart = None, None, 0
    jfif = adobe_transform = None
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
        elif marker in (0xC0, 0xC1):
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
                c.idx, c.val = [], []
            frame = (width, height, hmax, vmax, mcux, mcuy)
        elif marker in _UNSUPPORTED_SOF:
            raise NotImplementedError(f"{path}: {_UNSUPPORTED_SOF[marker]} JPEG is not "
                                      f"supported (baseline and extended sequential Huffman "
                                      f"only)")
        elif marker == 0xCC:
            raise NotImplementedError(f"{path}: arithmetic-coded JPEG is not supported")
        elif marker == 0xC4:
            i = 0
            while i < len(body):
                tc, th = body[i] >> 4, body[i] & 15
                counts = list(body[i + 1: i + 17])
                n = sum(counts)
                lut = _huffman_lut(counts, list(body[i + 17: i + 17 + n]))
                (ac_tabs if tc else dc_tabs)[th] = lut
                i += 17 + n
        elif marker == 0xDD:
            restart = (body[0] << 8) | body[1]
        elif marker == 0xDA:
            if frame is None:
                raise ValueError(f"{path}: corrupt JPEG (SOS before SOF)")
            ns = body[0]
            scan = []
            for k in range(ns):
                cid, tables = body[1 + 2 * k], body[2 + 2 * k]
                ci = next(i for i, c in enumerate(comps) if c.id == cid)
                scan.append((ci, dc_tabs[tables >> 4], ac_tabs[tables & 15]))
            ss, se, ahal = body[1 + 2 * ns], body[2 + 2 * ns], body[3 + 2 * ns]
            if ss != 0 or se != 63 or ahal != 0:
                raise NotImplementedError(f"{path}: progressive JPEG scans are not supported")
            pos = _decode_scan(blob, pos, frame, comps, scan, restart)
            if pos >= len(blob):
                break                  # no EOI: libjpeg accepts a truncated end
        elif marker == 0xD9:
            break
    if frame is None:
        raise ValueError(f"{path}: no frame header (SOF) in the JPEG")
    width, height, hmax, vmax = frame[:4]

    planes = []
    for c in comps:
        if c.tq not in qt:
            raise ValueError(f"{path}: quantisation table {c.tq} is missing")
        blocks = np.zeros(c.bh * c.bw * 64, np.int64)
        blocks[np.asarray(c.idx, np.int64)] = c.val
        px = idct_islow(blocks.reshape(-1, 64), qt[c.tq])            # [bh * bw, 8, 8]
        plane = px.reshape(c.bh, c.bw, 8, 8).transpose(0, 2, 1, 3).reshape(c.bh * 8, c.bw * 8)
        planes.append(_upsample(plane, c, hmax, vmax, width, height))
    if len(comps) == 1:
        return planes[0].astype(np.uint8)[..., None]
    ids = tuple(c.id for c in comps)
    rgb = (adobe_transform == 0 if adobe_transform is not None and not jfif
           else (not jfif and ids == (82, 71, 66)))
    if rgb:
        return np.stack(planes[::-1], -1).astype(np.uint8)
    return ycc_to_bgr(*planes)


def _decode_scan(blob, pos, frame, comps, scan, restart):
    """Decode one sequential scan starting at `pos`; returns the offset of
    the marker after it.  Coefficients go to each component's idx/val
    lists (flat indices into its MCU-padded block grid)."""
    width, height, hmax, vmax, mcux, mcuy = frame
    intervals, end = _entropy_data(blob, pos)
    units = []
    if len(scan) == 1:
        ci, dc, ac = scan[0]
        c = comps[ci]
        # a single-component scan covers the component's own blocks, in rows
        bw = -(-(-(-width * c.h // hmax)) // 8)
        bh = -(-(-(-height * c.v // vmax)) // 8)
        n_units = bw * bh

        def base_of(u, bw=bw, cbw=c.bw):
            return ((u // bw) * cbw + u % bw) * 64

        units.append((ci, dc, ac, base_of, c.idx, c.val))
    else:
        n_units = mcux * mcuy
        for ci, dc, ac in scan:
            c = comps[ci]
            for v in range(c.v):
                for h in range(c.h):
                    def base_of(m, c=c, h=h, v=v):
                        return (((m // mcux) * c.v + v) * c.bw + (m % mcux) * c.h + h) * 64

                    units.append((ci, dc, ac, base_of, c.idx, c.val))
    per = restart or n_units
    done = 0
    for data in intervals:
        if done >= n_units:
            break
        n = min(per, n_units - done)
        preds = [0] * len(comps)
        shifted = [(ci, dc, ac, (lambda m, f=f, d=done: f(m + d)), oi, ov)
                   for ci, dc, ac, f, oi, ov in units]
        _decode_interval(data, shifted, preds, n)
        done += n
    return end

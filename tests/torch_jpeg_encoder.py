"""An arithmetic-coding JPEG writer for the tests: the QM encoder of
libjpeg's jcarith.c and its MCU encoders (sequential, and the progressive
DC first / DC refine / AC first / AC refine scans), over quantised
coefficients such as data/jpeg.py's read_coefficients gives.

Nothing of the decoder is reused here but its coefficient reader: the MCU
geometry, the statistics and the QM coder are written again from the
encoder's side, so that a file written here and decoded equal by cv2 tests
the decoder's reading of the format.

    encode_arith(coefs, progressive=False, restart=0, dac=None, script=None)

returns the bytes of a JFIF file: SOF9 (sequential) or SOF10 (progressive,
libjpeg's jpeg_simple_progression script unless another is given: a list of
(component indices, Ss, Se, Ah, Al)), conditioning table 0 for the first
component and 1 for the others, a DAC marker when ``dac`` maps a table
("dc0", "dc1", "ac0", "ac1") to its (L, U) or Kx, and a restart interval of
``restart`` MCUs.
"""
import struct

import numpy as np

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)

# jaricom.c: (Qe, next state after an LPS, after an MPS, LPS switches the MPS)
QM_TABLE = [
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

# jcparam.c's jpeg_simple_progression for YCbCr and for one component
SIMPLE_PROGRESSION_3 = [([0, 1, 2], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([2], 1, 63, 0, 1),
                        ([1], 1, 63, 0, 1), ([0], 6, 63, 0, 2), ([0], 1, 63, 2, 1),
                        ([0, 1, 2], 0, 0, 1, 0), ([2], 1, 63, 1, 0), ([1], 1, 63, 1, 0),
                        ([0], 1, 63, 1, 0)]
SIMPLE_PROGRESSION_1 = [([0], 0, 0, 0, 1), ([0], 1, 5, 0, 2), ([0], 6, 63, 0, 2),
                        ([0], 1, 63, 2, 1), ([0], 0, 0, 1, 0), ([0], 1, 63, 1, 0)]


class QMEncoder:
    """jcarith.c's arith_encode and finish_pass, writing bytes with 0xFF
    stuffed."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct, self.buffer = 0, 0x10000, 0, 0, 11, -1

    def _emit(self, byte):
        self.out.append(byte)

    def _flush_zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st, i, val):
        sv = st[i]
        qe, nl, nm, switch = QM_TABLE[sv & 0x7F]
        self.a -= qe
        if val != (sv >> 7):
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ (nl | (switch << 7))
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:                                   # renormalisation and output
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer + 1)
                        if self.buffer + 1 == 0xFF:
                            self._emit(0)
                    self.zc += self.sc
                    self.sc = 0
                    self.buffer = temp & 0xFF
                elif temp == 0xFF:
                    self.sc += 1
                else:
                    if self.buffer == 0:
                        self.zc += 1
                    elif self.buffer >= 0:
                        self._flush_zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._flush_zeros()
                        for _ in range(self.sc):
                            self._emit(0xFF)
                            self._emit(0)
                        self.sc = 0
                    self.buffer = temp & 0xFF
                self.c &= 0x7FFFF
                self.ct += 8
            if self.a >= 0x8000:
                break

    def finish(self):
        temp = (self.a - 1 + self.c) & 0xFFFF0000
        self.c = temp + 0x8000 if temp < self.c else temp
        self.c <<= self.ct
        if self.c & 0xF8000000:
            if self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._flush_zeros()
                self._emit(self.buffer)
            if self.sc:
                self._flush_zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._flush_zeros()
            self._emit((self.c >> 19) & 0xFF)
            if ((self.c >> 19) & 0xFF) == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if ((self.c >> 11) & 0xFF) == 0xFF:
                    self._emit(0)


def _point(v, al):
    """The AC point transform: |v| >> al with v's sign kept apart."""
    return (v >> al) if v >= 0 else -((-v) >> al)


class _ScanEncoder:
    def __init__(self, qm, dac):
        self.qm, self.dac = qm, dac
        self.fixed = [113]

    def start(self, tables, dc, ac):
        self.dc_stats = {td: [0] * 64 for td, _ in tables} if dc else {}
        self.ac_stats = {ta: [0] * 256 for _, ta in tables} if ac else {}
        self.last = {}
        self.ctx = {}

    def dc_diff(self, key, td, v):
        """Figures F.4-F.9: one DC difference."""
        enc, st = self.qm.encode, self.dc_stats[td]
        s0 = self.ctx.get(key, 0)
        if v == 0:
            enc(st, s0, 0)
            self.ctx[key] = 0
            return
        enc(st, s0, 1)
        if v > 0:
            enc(st, s0 + 1, 0)
            i, ctx = s0 + 2, 4
        else:
            v = -v
            enc(st, s0 + 1, 1)
            i, ctx = s0 + 3, 8
        m = 0
        v -= 1
        if v:
            enc(st, i, 1)
            m = 1
            v2 = v
            i = 20
            v2 >>= 1
            while v2:
                enc(st, i, 1)
                m <<= 1
                i += 1
                v2 >>= 1
        enc(st, i, 0)
        lo, hi = self.dac.get(f"dc{td}", (0, 1))
        if m < (1 << lo) >> 1:
            ctx = 0
        elif m > (1 << hi) >> 1:
            ctx += 8
        self.ctx[key] = ctx
        i += 14
        m >>= 1
        while m:
            enc(st, i, 1 if m & v else 0)
            m >>= 1

    def ac_value(self, ta, k, v):
        """Figures F.7-F.9 after the nonzero decision: |v| with its sign."""
        enc, st = self.qm.encode, self.ac_stats[ta]
        i = 3 * (k - 1) + 2
        m = 0
        v -= 1
        if v:
            enc(st, i, 1)
            m = 1
            v2 = v >> 1
            if v2:
                enc(st, i, 1)
                m <<= 1
                i = 189 if k <= self.dac.get(f"ac{ta}", 5) else 217
                v2 >>= 1
                while v2:
                    enc(st, i, 1)
                    m <<= 1
                    i += 1
                    v2 >>= 1
        enc(st, i, 0)
        i += 14
        m >>= 1
        while m:
            enc(st, i, 1 if m & v else 0)
            m >>= 1

    def ac_block(self, ta, zz, ss, se, al):
        """encode_mcu's AC part and encode_mcu_AC_first (Figure F.5)."""
        enc, st = self.qm.encode, self.ac_stats[ta]
        vals = [_point(int(x), al) for x in zz]
        ke = se
        while ke > 0 and vals[ke] == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            enc(st, i, 0)
            while vals[k] == 0:
                enc(st, i + 1, 0)
                i += 3
                k += 1
            enc(st, i + 1, 1)
            enc(self.fixed, 0, 1 if vals[k] < 0 else 0)
            self.ac_value(ta, k, abs(vals[k]))
            k += 1
        if k <= se:
            enc(st, 3 * (k - 1), 1)

    def ac_refine(self, ta, zz, ss, se, ah, al):
        """encode_mcu_AC_refine (Figure G.10)."""
        enc, st = self.qm.encode, self.ac_stats[ta]
        mag = [abs(int(x)) for x in zz]
        ke = se
        while ke > 0 and (mag[ke] >> al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and (mag[kex] >> ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                enc(st, i, 0)
            while True:
                v = mag[k] >> al
                if v:
                    if v >> 1:
                        enc(st, i + 2, v & 1)
                    else:
                        enc(st, i + 1, 1)
                        enc(self.fixed, 0, 1 if zz[k] < 0 else 0)
                    break
                enc(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            enc(st, 3 * (k - 1), 1)


def _units(coefs, cis):
    """(MCUs, [(component index, [block row of each MCU])]) of a scan."""
    hmax, vmax, mcux, mcuy = coefs.hmax, coefs.vmax, coefs.mcux, coefs.mcuy
    if len(cis) == 1:
        c = coefs.comps[cis[0]]
        bw = -(-(-(-coefs.width * c.h // hmax)) // 8)
        bh = -(-(-(-coefs.height * c.v // vmax)) // 8)
        return bw * bh, [(cis[0], [(u // bw) * c.bw + u % bw for u in range(bw * bh)])]
    units = []
    for ci in cis:
        c = coefs.comps[ci]
        for v in range(c.v):
            for h in range(c.h):
                units.append((ci, [((m // mcux) * c.v + v) * c.bw + (m % mcux) * c.h + h
                                   for m in range(mcux * mcuy)]))
    return mcux * mcuy, units


def _segment(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def encode_arith(coefs, progressive=False, restart=0, dac=None, script=None):
    """An arithmetic-coded JFIF file of ``coefs`` (see the module docstring)."""
    dac = dac or {}
    comps = coefs.comps
    zz = [np.asarray(c.blocks)[:, ZIGZAG].astype(np.int64) for c in comps]
    table = [0] + [1] * (len(comps) - 1)
    out = bytearray(b"\xff\xd8")
    out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for tq in sorted({c.tq for c in comps}):
        q = next(c.q for c in comps if c.tq == tq)
        out += _segment(0xDB, bytes([tq]) + bytes(int(x) for x in np.asarray(q)[ZIGZAG]))
    sof = struct.pack(">BHHB", 8, coefs.height, coefs.width, len(comps))
    sof += b"".join(bytes([c.id, (c.h << 4) | c.v, c.tq]) for c in comps)
    out += _segment(0xCA if progressive else 0xC9, sof)
    if dac:
        body = b""
        for name, val in sorted(dac.items()):
            tb = int(name[2:])
            if name.startswith("dc"):
                body += bytes([tb, (val[1] << 4) | val[0]])
            else:
                body += bytes([0x10 | tb, val])
        out += _segment(0xCC, body)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    if not progressive:
        script = [(list(range(len(comps))), 0, 63, 0, 0)]
    elif script is None:
        script = SIMPLE_PROGRESSION_3 if len(comps) == 3 else SIMPLE_PROGRESSION_1
    for cis, ss, se, ah, al in script:
        sos = bytes([len(cis)]) + b"".join(
            bytes([comps[ci].id, (table[ci] << 4) | table[ci]]) for ci in cis)
        out += _segment(0xDA, sos + bytes([ss, se, (ah << 4) | al]))
        out += _scan(coefs, zz, cis, [(table[ci], table[ci]) for ci in cis], progressive,
                     ss, se, ah, al, restart, dac)
    return bytes(out + b"\xff\xd9")


def _scan(coefs, zz, cis, tables, progressive, ss, se, ah, al, restart, dac):
    qm = QMEncoder()
    enc = _ScanEncoder(qm, dac)
    n_mcu, units = _units(coefs, cis)
    per = restart or n_mcu
    dc_scan = not progressive or (ss == 0 and ah == 0)
    ac_scan = not progressive or ss > 0
    for m0 in range(0, n_mcu, per):
        if m0:
            qm.finish()
            qm.out += bytes([0xFF, 0xD0 + (m0 // per - 1) % 8])
            qm.reset()
        enc.start(tables, dc_scan, ac_scan)
        for m in range(m0, min(m0 + per, n_mcu)):
            for ci, rows in units:
                td, ta = tables[cis.index(ci)]
                block = zz[ci][rows[m]]
                if progressive and ss == 0 and ah:
                    qm.encode(enc.fixed, 0, (int(block[0]) >> al) & 1)
                elif progressive and ss == 0:
                    dc = int(block[0]) >> al
                    enc.dc_diff(ci, td, dc - enc.last.get(ci, 0))
                    enc.last[ci] = dc
                elif progressive and ah:
                    enc.ac_refine(ta, block, ss, se, ah, al)
                elif progressive:
                    enc.ac_block(ta, block, ss, se, al)
                else:
                    dc = int(block[0])
                    enc.dc_diff(ci, td, dc - enc.last.get(ci, 0))
                    enc.last[ci] = dc
                    enc.ac_block(ta, block, 1, 63, 0)
    qm.finish()
    return bytes(qm.out)

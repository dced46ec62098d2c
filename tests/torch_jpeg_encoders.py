"""Small JPEG encoders for the decoder's tests: what PIL decodes but cannot
write. Imports numpy only.

  - `encode_arith(img, ...)`: arithmetic coding (ITU T.81 Annex D, F.1.4,
    G.1.3; libjpeg's jcarith.c), sequential (SOF9) or progressive (SOF10)
    with a fixed scan script, 1, 3 or 4 components, any sampling
    factors, restart intervals and DAC conditioning;
  - `encode_lossless(img, predictor, ...)`: lossless Huffman coding
    (SOF3, Annex H): predictors 1-7, a point transform, restarts of whole
    rows;
  - `truncated_scans(blob, n)`: a progressive file cut after its n-th
    scan (libjpeg-turbo smooths the blocks whose coefficients it left
    unknown).

The DCT coefficients come from a float forward DCT of the image (YCbCr
for 3 components, as JFIF) quantized by libjpeg's tables at a quality:
the tests need valid streams, and PIL's decode of them is the reference.
"""

from __future__ import annotations

import struct

import numpy as np

NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])
LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
CHROMA_Q = np.array([17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99,
                     99, 99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99,
                     99, 99, 99, 99] + [99] * 32)

# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS);
# entry 113 is the fixed 0.5 estimate of signs and refinement bits
QE = [
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0)]


def _segment(marker: int, body: bytes) -> bytes:
    return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body


def _quant_tables(quality: int):
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return [np.clip((q * scale + 50) // 100, 1, 255) for q in (LUMA_Q,
                                                              CHROMA_Q)]


def _dct_matrix() -> np.ndarray:
    k = np.arange(8)
    m = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    m *= np.sqrt(2 / 8)
    m[0] /= np.sqrt(2)
    return m


def coefficients(img: np.ndarray, sampling, quality: int):
    """[(h, v, table index, (bh, bw, 64) int coefficients in natural
    order)] of each component, MCU-padded, and the quantization tables.
    A 3-channel image is coded as YCbCr, others as they are."""
    img = np.asarray(img, np.float64)
    if img.ndim == 2:
        img = img[..., None]
    height, width, n = img.shape
    if n == 3:
        r, g, b = img[..., 0], img[..., 1], img[..., 2]
        img = np.stack([0.299 * r + 0.587 * g + 0.114 * b,
                        -0.168736 * r - 0.331264 * g + 0.5 * b + 128,
                        0.5 * r - 0.418688 * g - 0.081312 * b + 128], -1)
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
    tables = _quant_tables(quality)
    dct = _dct_matrix()
    out = []
    for ci, (h, v) in enumerate(sampling):
        plane = img[..., ci]
        fy, fx = vmax // v, hmax // h
        ph, pw = mcuy * 8 * vmax, mcux * 8 * hmax
        plane = np.pad(plane, ((0, ph - height), (0, pw - width)), "edge")
        plane = plane.reshape(ph // fy, fy, pw // fx, fx).mean((1, 3))
        bh, bw = mcuy * v, mcux * h
        blocks = plane.reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3) - 128
        coef = dct @ blocks @ dct.T
        tq = 0 if (ci == 0 or n == 4) else 1
        q = tables[tq].reshape(8, 8)
        out.append((h, v, tq, np.round(coef / q).astype(np.int64).reshape(
            bh, bw, 64)))
    return out, tables, (mcux, mcuy, hmax, vmax)


class ArithEncoder:
    """The QM coder of jcarith.c: arith_encode and finish_pass."""

    def __init__(self):
        self.out = bytearray()
        self.reset()

    def reset(self):
        self.c, self.a, self.sc, self.zc, self.ct = 0, 0x10000, 0, 0, 11
        self.buffer = -1

    def _emit(self, b: int):
        self.out.append(b)

    def _zeros(self):
        while self.zc:
            self._emit(0)
            self.zc -= 1

    def encode(self, st: list, i: int, val: int):
        sv = st[i]
        qe, nl, nm, switch = QE[sv & 0x7F]
        self.a -= qe
        if val != sv >> 7:  # the less probable symbol
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nl ^ (switch << 7)
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (sv & 0x80) ^ nm
        while True:  # renormalization, D.1.6
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                temp = self.c >> 19
                if temp > 0xFF:
                    if self.buffer >= 0:
                        self._zeros()
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
                        self._zeros()
                        self._emit(self.buffer)
                    if self.sc:
                        self._zeros()
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
                self._zeros()
                self._emit(self.buffer + 1)
                if self.buffer + 1 == 0xFF:
                    self._emit(0)
            self.zc += self.sc
            self.sc = 0
        else:
            if self.buffer == 0:
                self.zc += 1
            elif self.buffer >= 0:
                self._zeros()
                self._emit(self.buffer)
            if self.sc:
                self._zeros()
                for _ in range(self.sc):
                    self._emit(0xFF)
                    self._emit(0)
                self.sc = 0
        if self.c & 0x7FFF800:
            self._zeros()
            self._emit((self.c >> 19) & 0xFF)
            if (self.c >> 19) & 0xFF == 0xFF:
                self._emit(0)
            if self.c & 0x7F800:
                self._emit((self.c >> 11) & 0xFF)
                if (self.c >> 11) & 0xFF == 0xFF:
                    self._emit(0)
        self.zc = 0


class _ArithScan:
    """One scan's statistics and the per-block coding of jcarith.c."""

    def __init__(self, enc: ArithEncoder, ncomp: int, dc_l, dc_u, ac_k):
        self.enc = enc
        self.dc_l, self.dc_u, self.ac_k = dc_l, dc_u, ac_k
        self.fixed = [113]
        self.dc_stats = [[0] * 64 for _ in range(4)]
        self.ac_stats = [[0] * 256 for _ in range(4)]
        self.last = [0] * ncomp
        self.context = [0] * ncomp

    def restart_stats(self, dc: bool, ac: bool):
        if dc:
            self.dc_stats = [[0] * 64 for _ in range(4)]
            self.last = [0] * len(self.last)
            self.context = [0] * len(self.context)
        if ac:
            self.ac_stats = [[0] * 256 for _ in range(4)]

    def _magnitude(self, st, i, v, ac_tbl=None, k=0, dc_st=None):
        """F.8: the magnitude category of v >= 1 (of v - 1) from bin i of
        `st`, its X bins those of the DC table `dc_st` or of the AC table
        `ac_tbl` (coefficient k); returns the bins, m and v - 1 for the
        magnitude bits (F.9)."""
        e = self.enc
        m = 0
        v -= 1
        if v:
            e.encode(st, i, 1)
            m = 1
            v2 = v
            if ac_tbl is None:
                st, i = dc_st, 20
                while v2 >> 1:
                    v2 >>= 1
                    e.encode(st, i, 1)
                    m <<= 1
                    i += 1
            else:
                v2 >>= 1
                if v2:
                    e.encode(st, i, 1)
                    m <<= 1
                    st, i = self.ac_stats[ac_tbl], (
                        189 if k <= self.ac_k[ac_tbl] else 217)
                    while v2 >> 1:
                        v2 >>= 1
                        e.encode(st, i, 1)
                        m <<= 1
                        i += 1
        e.encode(st, i, 0)
        return st, i, m, v

    def dc(self, ci: int, tbl: int, value: int):
        e = self.enc
        st = self.dc_stats[tbl]
        i = self.context[ci]
        v = value - self.last[ci]
        if v == 0:
            e.encode(st, i, 0)
            self.context[ci] = 0
            return
        self.last[ci] = value
        e.encode(st, i, 1)
        if v > 0:
            e.encode(st, i + 1, 0)
            i += 2
            self.context[ci] = 4
        else:
            v = -v
            e.encode(st, i + 1, 1)
            i += 3
            self.context[ci] = 8
        st, i, m, v = self._magnitude(st, i, v, dc_st=self.dc_stats[tbl])
        if m < (1 << self.dc_l[tbl]) >> 1:
            self.context[ci] = 0
        elif m > (1 << self.dc_u[tbl]) >> 1:
            self.context[ci] += 8
        i += 14
        while m > 1:
            m >>= 1
            e.encode(st, i, 1 if m & v else 0)

    def ac(self, tbl: int, blk, ss: int, se: int, al: int):
        """A sequential block's AC band or a progressive first scan's."""
        e, st = self.enc, self.ac_stats[tbl]

        def shifted(k):
            v = int(blk[NATURAL[k]])
            return (v >> al) if v >= 0 else -((-v) >> al)
        ke = se
        while ke >= ss and shifted(ke) == 0:
            ke -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            e.encode(st, i, 0)
            while shifted(k) == 0:
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            v = shifted(k)
            e.encode(st, i + 1, 1)
            e.encode(self.fixed, 0, 1 if v < 0 else 0)
            st2, i2, m, v = self._magnitude(st, i + 2, abs(v), tbl, k)
            i2 += 14
            while m > 1:
                m >>= 1
                e.encode(st2, i2, 1 if m & v else 0)
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)

    def ac_refine(self, tbl: int, blk, ss: int, se: int, ah: int, al: int):
        e, st = self.enc, self.ac_stats[tbl]

        def shifted(k, bits):
            v = int(blk[NATURAL[k]])
            return (v >> bits) if v >= 0 else -((-v) >> bits)
        ke = se
        while ke > 0 and shifted(ke, al) == 0:
            ke -= 1
        kex = ke
        while kex > 0 and shifted(kex, ah) == 0:
            kex -= 1
        k = ss
        while k <= ke:
            i = 3 * (k - 1)
            if k > kex:
                e.encode(st, i, 0)
            while True:
                v = shifted(k, al)
                if v:
                    a = abs(v)
                    if a >> 1:
                        e.encode(st, i + 2, a & 1)
                    else:
                        e.encode(st, i + 1, 1)
                        e.encode(self.fixed, 0, 1 if v < 0 else 0)
                    break
                e.encode(st, i + 1, 0)
                i += 3
                k += 1
            k += 1
        if k <= se:
            e.encode(st, 3 * (k - 1), 1)


PROGRESSIVE_SCRIPT = {  # (components, Ss, Se, Ah, Al), libjpeg-like
    1: [((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((0,), 6, 63, 0, 2),
        ((0,), 1, 63, 2, 1), ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0)],
    3: [((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2), ((2,), 1, 63, 0, 1),
        ((1,), 1, 63, 0, 1), ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
        ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0), ((1,), 1, 63, 1, 0),
        ((0,), 1, 63, 1, 0)],
}
PROGRESSIVE_SCRIPT[4] = [((0, 1, 2, 3), 0, 0, 0, 1)] + [
    ((c,), 1, 63, 0, 1) for c in range(4)] + [((0, 1, 2, 3), 0, 0, 1, 0)] + [
    ((c,), 1, 63, 1, 0) for c in range(4)]


def encode_arith(img: np.ndarray, *, progressive: bool = False,
                 sampling=None, quality: int = 75, restart: int = 0,
                 dac=None, adobe: bool = False) -> bytes:
    """An arithmetic-coded JPEG file of `img` ((h, w) gray, (h, w, 3) RGB
    coded as YCbCr with a JFIF marker, (h, w, 4) CMYK with an Adobe
    marker). `restart`: the restart interval in MCUs; `dac`: {(class,
    table): value} of a DAC segment (class 0: DC L | U << 4, 1: AC K)."""
    img = np.asarray(img)
    n = 1 if img.ndim == 2 else img.shape[2]
    sampling = sampling or [(1, 1)] * n
    # libjpeg stores CMYK inverted (PIL's "CMYK;I")
    comps, tables, (mcux, mcuy, _, _) = coefficients(
        255 - img.astype(np.int64) if n == 4 else img, sampling, quality)
    height, width = img.shape[:2]
    out = bytearray(b"\xff\xd8")
    if n == 4 or adobe:
        out += _segment(0xEE, b"Adobe" + struct.pack(">HHHB", 100, 0, 0, 0))
    elif n == 3:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t, q in enumerate(tables[:1 if n in (1, 4) else 2]):
        out += _segment(0xDB, bytes([t]) + bytes(int(x) for x in q[NATURAL]))
    dc_l, dc_u, ac_k = [0] * 4, [1] * 4, [5] * 4
    if dac:
        body = bytearray()
        for (cls, tbl), value in sorted(dac.items()):
            body += bytes([cls << 4 | tbl, value])
            if cls:
                ac_k[tbl] = value
            else:
                dc_l[tbl], dc_u[tbl] = value & 15, value >> 4
        out += _segment(0xCC, bytes(body))
    frame = struct.pack(">BHHB", 8, height, width, n)
    for i, (h, v, tq, _) in enumerate(comps):
        frame += bytes([i + 1, h << 4 | v, tq])
    out += _segment(0xCA if progressive else 0xC9, frame)
    if restart:
        out += _segment(0xDD, struct.pack(">H", restart))
    script = (PROGRESSIVE_SCRIPT[n] if progressive
              else [(tuple(range(n)), 0, 63, 0, 0)])
    for cs, ss, se, ah, al in script:
        tbls = [comps[c][2] for c in cs]
        sos = bytes([len(cs)]) + b"".join(bytes([c + 1, t << 4 | t])
                                         for c, t in zip(cs, tbls))
        out += _segment(0xDA, sos + bytes([ss, se, ah << 4 | al]))
        out += _arith_scan(comps, cs, ss, se, ah, al, progressive, restart,
                           (mcux, mcuy), (width, height), dc_l, dc_u, ac_k)
    return bytes(out + b"\xff\xd9")


def _arith_scan(comps, cs, ss, se, ah, al, progressive, restart, mcus,
                size, dc_l, dc_u, ac_k) -> bytes:
    enc = ArithEncoder()
    scan = _ArithScan(enc, len(cs), dc_l, dc_u, ac_k)
    dc_scan, ac_scan = ss == 0 and ah == 0, not progressive or ss > 0
    if len(cs) == 1:  # the component's own blocks, not the padded ones
        h, v, _, coef = comps[cs[0]]
        width, height = size
        hmax, vmax = max(c[0] for c in comps), max(c[1] for c in comps)
        bw = -(-(-(-width * h // hmax)) // 8)
        bh = -(-(-(-height * v // vmax)) // 8)
        units = [[(0, coef[y, x])] for y in range(bh) for x in range(bw)]
    else:
        mcux, mcuy = mcus
        units = []
        for my in range(mcuy):
            for mx in range(mcux):
                unit = []
                for i, c in enumerate(cs):
                    h, v, _, coef = comps[c]
                    for by in range(v):
                        for bx in range(h):
                            unit.append((i, coef[my * v + by, mx * h + bx]))
                units.append(unit)
    out = bytearray()
    for m, unit in enumerate(units):
        if restart and m and m % restart == 0:
            enc.finish()
            out += enc.out + bytes([0xFF, 0xD0 + (m // restart - 1) % 8])
            enc.out = bytearray()
            enc.reset()
            scan.restart_stats(dc_scan, ac_scan)
        for i, blk in unit:
            tbl = comps[cs[i]][2]
            if not progressive:
                scan.dc(i, tbl, int(blk[0]))
                scan.ac(tbl, blk, 1, 63, 0)
            elif ss == 0 and ah == 0:
                scan.dc(i, tbl, int(blk[0]) >> al)
            elif ss == 0:
                enc.encode(scan.fixed, 0, (int(blk[0]) >> al) & 1)
            elif ah == 0:
                scan.ac(tbl, blk, ss, se, al)
            else:
                scan.ac_refine(tbl, blk, ss, se, ah, al)
    enc.finish()
    return bytes(out + enc.out)


# -- lossless -------------------------------------------------------------

def _predict(p: int, ra: int, rb: int, rc: int) -> int:
    return {1: ra, 2: rb, 3: rc, 4: ra + rb - rc, 5: ra + ((rb - rc) >> 1),
            6: rb + ((ra - rc) >> 1), 7: (ra + rb) >> 1}[p]


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, value: int, n: int):
        for i in range(n - 1, -1, -1):
            self.acc = self.acc << 1 | (value >> i) & 1
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)
                self.acc, self.n = 0, 0

    def flush(self) -> bytes:
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)
        out, self.out = bytes(self.out), bytearray()
        return out


def _differences(s, predictor, pt, first):
    """The differences of the (h, w) samples `s` (already shifted by the
    point transform); first[y]: row y restarts the prediction."""
    height, width = s.shape
    d = np.zeros_like(s)
    initial = 1 << (8 - pt - 1)
    for y in range(height):
        for x in range(width):
            if first[y]:
                pred = initial if x == 0 else s[y, x - 1]
            elif x == 0:
                pred = s[y - 1, 0]
            else:
                pred = _predict(predictor, s[y, x - 1], s[y - 1, x],
                                s[y - 1, x - 1])
            d[y, x] = (s[y, x] - pred + 32768) % 65536 - 32768
    return d


def encode_lossless(img: np.ndarray, predictor: int, *, pt: int = 0,
                    restart_rows: int = 0, interleaved: bool = True,
                    jfif: bool = False, sampling=None) -> bytes:
    """A lossless Huffman-coded JPEG file (SOF3) of `img` ((h, w) or
    (h, w, c) uint8, c = 3 or 4; components with ids 1..c, no colour
    transform; `jfif` adds a JFIF marker, which makes libjpeg read three
    components as YCbCr). `sampling`: (h, v) per component (a subsampled
    component is the rounded mean of its pixels); `restart_rows`: MCU
    rows per restart interval (a non-interleaved file restarts every
    `restart_rows` rows of equal-sized components). One Huffman table:
    every category 0-16 a 5-bit code."""
    img = np.asarray(img, np.int64)
    if img.ndim == 2:
        img = img[..., None]
    height, width, n = img.shape
    sampling = sampling or [(1, 1)] * n
    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    mcux, mcuy = -(-width // hmax), -(-height // vmax)
    planes = []  # (the MCU-padded samples, real height, real width)
    for c, (h, v) in enumerate(sampling):
        full = np.pad(img[..., c], ((0, mcuy * vmax - height),
                                    (0, mcux * hmax - width)), "edge")
        plane = np.round(full.reshape(mcuy * v, vmax // v, mcux * h,
                                      hmax // h).mean((1, 3)))
        planes.append((plane.astype(np.int64) >> pt,
                       -(-height * v // vmax), -(-width * h // hmax)))
    out = bytearray(b"\xff\xd8")
    if jfif:
        out += _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    counts = [0] * 16
    counts[4] = 17
    out += _segment(0xC4, bytes([0]) + bytes(counts) + bytes(range(17)))
    frame = struct.pack(">BHHB", 8, height, width, n)
    for i, (h, v) in enumerate(sampling):
        frame += bytes([i + 1, h << 4 | v, 0])
    out += _segment(0xC3, frame)
    if restart_rows:
        assert interleaved or len({p[2] for p in planes}) == 1
        per_row = mcux if interleaved else planes[0][2]
        out += _segment(0xDD, struct.pack(">H", restart_rows * per_row))
    bits = _Bits()

    def put(d):
        d = int(d)
        size = 0 if d == 0 else (16 if d == -32768 else abs(d).bit_length())
        bits.put(size, 5)
        if 0 < size < 16:
            bits.put(d if d > 0 else d + (1 << size) - 1, size)

    def restart(row, count):
        if restart_rows and row and row % restart_rows == 0:
            out.extend(bits.flush() + bytes(
                [0xFF, 0xD0 + (count - 1) % 8]))
            return count + 1
        return count

    if interleaved:  # MCUs of h x v samples of each component
        diffs = []
        for (plane, _, _), (h, v) in zip(planes, sampling):
            rows = plane.shape[0]
            first = [y == 0 or (restart_rows and y % v == 0
                                and (y // v) % restart_rows == 0)
                     for y in range(rows)]
            diffs.append(_differences(plane, predictor, pt, first))
        sos = bytes([n]) + b"".join(bytes([c + 1, 0]) for c in range(n))
        out += _segment(0xDA, sos + bytes([predictor, 0, pt]))
        count = 1
        for my in range(mcuy):
            count = restart(my, count)
            for mx in range(mcux):
                for d, (h, v) in zip(diffs, sampling):
                    for y in range(v):
                        for x in range(h):
                            put(d[my * v + y, mx * h + x])
        out += bits.flush()
    else:  # one scan a component, over its real samples
        for c, (plane, dh, dw) in enumerate(planes):
            first = [y == 0 or (restart_rows and y % restart_rows == 0)
                     for y in range(dh)]
            d = _differences(plane[:dh, :dw], predictor, pt, first)
            sos = bytes([1, c + 1, 0])
            out += _segment(0xDA, sos + bytes([predictor, 0, pt]))
            count = 1
            for y in range(dh):
                count = restart(y, count)
                for x in range(dw):
                    put(d[y, x])
            out += bits.flush()
    return bytes(out + b"\xff\xd9")


def scan_starts(blob: bytes):
    """The offsets of the file's SOS markers."""
    return [i for i in range(len(blob) - 1) if blob[i:i + 2] == b"\xff\xda"]


def truncated_scans(blob: bytes, n: int) -> bytes:
    """The progressive file `blob` with only its first n scans, then EOI."""
    return blob[:scan_starts(blob)[n]] + b"\xff\xd9"

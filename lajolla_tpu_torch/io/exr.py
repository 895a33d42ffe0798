"""Self-contained OpenEXR scanline codec (pure Python + numpy).

Replaces the reference's vendored tinyexr (src/3rdparty/tinyexr.h, used by
src/image.cpp:4-6,86-133,152-173). Reader supports single-part scanline
images with NONE / RLE / ZIPS / ZIP / PIZ compression and uint/half/float
channels (PIZ: half only, which is what PIZ files contain in practice —
e.g. scenes/matpreview/envmap.exr). Writer emits ZIP-compressed half RGB,
matching the reference's SaveEXR(..., fp16) output format.

Format reference: the public OpenEXR file-format documentation
(openexr.com, "Technical Introduction to OpenEXR" and ImfHuf/ImfWav/
ImfPizCompressor algorithm descriptions).
"""

import struct
import zlib

import numpy as np

MAGIC = 0x01312F76

CT_NONE, CT_RLE, CT_ZIPS, CT_ZIP, CT_PIZ, CT_PXR24, CT_B44, CT_B44A = range(8)
LINES_PER_BLOCK = {CT_NONE: 1, CT_RLE: 1, CT_ZIPS: 1, CT_ZIP: 16, CT_PIZ: 32}
PT_UINT, PT_HALF, PT_FLOAT = 0, 1, 2
PT_SIZE = {PT_UINT: 4, PT_HALF: 2, PT_FLOAT: 4}
PT_DTYPE = {PT_UINT: '<u4', PT_HALF: '<f2', PT_FLOAT: '<f4'}


# ---------------------------------------------------------------------------
# Header parsing
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data):
        self.d = data
        self.p = 0

    def bytes(self, n):
        b = self.d[self.p:self.p + n]
        self.p += n
        return b

    def cstr(self):
        e = self.d.index(b'\0', self.p)
        s = self.d[self.p:e]
        self.p = e + 1
        return s

    def u32(self):
        return struct.unpack_from('<I', self.d, self._adv(4))[0]

    def i32(self):
        return struct.unpack_from('<i', self.d, self._adv(4))[0]

    def u64(self):
        return struct.unpack_from('<Q', self.d, self._adv(8))[0]

    def _adv(self, n):
        p = self.p
        self.p += n
        return p


def _parse_channels(raw):
    r = _Reader(raw)
    chans = []
    while True:
        name = r.cstr()
        if not name:
            break
        ptype = r.i32()
        r.bytes(4)  # pLinear + reserved
        xs = r.i32()
        ys = r.i32()
        chans.append((name.decode('latin-1'), ptype, xs, ys))
    return chans


def _read_header(r):
    attrs = {}
    while True:
        name = r.cstr()
        if not name:
            break
        typ = r.cstr()
        size = r.i32()
        attrs[name.decode('latin-1')] = (typ.decode('latin-1'), r.bytes(size))
    return attrs


# ---------------------------------------------------------------------------
# ZIP / RLE reconstruction (shared predictor + byte de-interleave)
# ---------------------------------------------------------------------------

def _reconstruct(data):
    """Undo the delta predictor then the even/odd byte split."""
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    if d.size == 0:
        return b''
    d[1:] -= 128
    t = (np.cumsum(d) & 0xFF).astype(np.uint8)
    out = np.empty_like(t)
    half = (t.size + 1) // 2
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def _deconstruct(data):
    """Inverse of _reconstruct, used by the writer."""
    t = np.frombuffer(data, np.uint8)
    if t.size == 0:
        return b''
    s = np.empty_like(t)
    half = (t.size + 1) // 2
    s[:half] = t[0::2]
    s[half:] = t[1::2]
    p = s.astype(np.int64)
    p[1:] = p[1:] - p[:-1] + 128
    return (p & 0xFF).astype(np.uint8).tobytes()


def _rle_decode(data):
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        count = struct.unpack_from('b', data, i)[0]
        i += 1
        if count < 0:
            out += data[i:i - count]
            i += -count
        else:
            out += data[i:i + 1] * (count + 1)
            i += 1
    return bytes(out)


# ---------------------------------------------------------------------------
# PIZ: Huffman decoding
# ---------------------------------------------------------------------------

_HUF_ENCSIZE = 65537
_SHORT_ZEROCODE_RUN = 59
_LONG_ZEROCODE_RUN = 63
_SHORTEST_LONG_RUN = 2 + _LONG_ZEROCODE_RUN - _SHORT_ZEROCODE_RUN
_DECBITS = 14
_DECMASK = (1 << _DECBITS) - 1


class _BitReader:
    """MSB-first bit reader over a byte buffer."""

    __slots__ = ('data', 'pos', 'acc', 'nbits')

    def __init__(self, data):
        self.data = data
        self.pos = 0
        self.acc = 0
        self.nbits = 0

    def fill(self, need):
        while self.nbits < need:
            b = self.data[self.pos] if self.pos < len(self.data) else 0
            self.pos += 1
            self.acc = ((self.acc << 8) | b) & 0xFFFFFFFFFFFFFFFF
            self.nbits += 8

    def get(self, n):
        self.fill(n)
        self.nbits -= n
        return (self.acc >> self.nbits) & ((1 << n) - 1)

    def peek(self, n):
        self.fill(n)
        return (self.acc >> (self.nbits - n)) & ((1 << n) - 1)

    def skip(self, n):
        self.nbits -= n


def _huf_unpack_enc_table(br, im, iM):
    lengths = np.zeros(_HUF_ENCSIZE, np.int64)
    i = im
    while i <= iM:
        l = br.get(6)
        if l == _LONG_ZEROCODE_RUN:
            zerun = br.get(8) + _SHORTEST_LONG_RUN
            i += zerun
        elif l >= _SHORT_ZEROCODE_RUN:
            zerun = l - _SHORT_ZEROCODE_RUN + 2
            i += zerun
        else:
            lengths[i] = l
            i += 1
    return lengths


def _huf_canonical_codes(lengths):
    """Assign canonical code values given per-symbol code lengths
    (OpenEXR's canonical-code construction)."""
    n = np.zeros(59, np.int64)
    for l in lengths[lengths > 0]:
        n[l] += 1
    c = 0
    base = np.zeros(59, np.int64)
    for i in range(58, 0, -1):
        nc = (c + n[i]) >> 1
        base[i] = c
        c = nc
    codes = np.zeros(_HUF_ENCSIZE, np.int64)
    nxt = base.copy()
    sym = np.nonzero(lengths > 0)[0]
    for s in sym:
        l = lengths[s]
        codes[s] = nxt[l]
        nxt[l] += 1
    return codes


def _huf_decode(data_bytes, im, iM, nbits, nraw):
    lengths_br = _BitReader(data_bytes)
    lengths = _huf_unpack_enc_table(lengths_br, im, iM)
    codes = _huf_canonical_codes(lengths)

    # Fast table for codes <= 14 bits; dict for longer codes.
    fast_sym = np.full(1 << _DECBITS, -1, np.int64)
    fast_len = np.zeros(1 << _DECBITS, np.int64)
    long_codes = {}
    for s in np.nonzero(lengths > 0)[0]:
        l = int(lengths[s])
        c = int(codes[s])
        if l <= _DECBITS:
            start = c << (_DECBITS - l)
            end = (c + 1) << (_DECBITS - l)
            fast_sym[start:end] = s
            fast_len[start:end] = l
        else:
            long_codes[(l, c)] = int(s)
    fast_sym_l = fast_sym.tolist()
    fast_len_l = fast_len.tolist()

    # Bit data starts right after the length table, at the byte boundary?
    # No: OpenEXR packs the code table and the data as one continuous
    # bit stream is NOT the case — the data starts at the next byte after
    # the table. The table reader consumed whole bytes via _BitReader.
    data_start = lengths_br.pos - (lengths_br.nbits // 8)
    br = _BitReader(data_bytes[data_start:])

    out = np.empty(nraw, np.uint32)
    n_out = 0
    rlc = iM
    max_long = max((l for (l, _) in long_codes), default=0)
    while n_out < nraw:
        idx = br.peek(_DECBITS)
        s = fast_sym_l[idx]
        if s >= 0:
            br.skip(fast_len_l[idx])
        else:
            # long code: extend bit by bit
            s = None
            for l in range(_DECBITS + 1, max_long + 1):
                c = br.peek(l)
                if (l, c) in long_codes:
                    s = long_codes[(l, c)]
                    br.skip(l)
                    break
            if s is None:
                raise ValueError("invalid Huffman code in PIZ data")
        if s == rlc:
            run = br.get(8)
            if n_out == 0:
                raise ValueError("PIZ RLE with no previous symbol")
            out[n_out:n_out + run] = out[n_out - 1]
            n_out += run
        else:
            out[n_out] = s
            n_out += 1
    return out.astype(np.uint16)


def _huf_uncompress(data, nraw):
    if nraw == 0:
        return np.zeros(0, np.uint16)
    im, iM, _tab, nbits, _ = struct.unpack_from('<IIIII', data, 0)
    if im >= _HUF_ENCSIZE or iM >= _HUF_ENCSIZE:
        raise ValueError("corrupt PIZ Huffman header")
    return _huf_decode(data[20:], im, iM, nbits, nraw)


# ---------------------------------------------------------------------------
# PIZ: 2D wavelet decoding
# ---------------------------------------------------------------------------

_A_OFFSET = 1 << 15
_MOD_MASK = (1 << 16) - 1


def _wdec14(l, h):
    ls = l.astype(np.int16).astype(np.int64)
    hi = h.astype(np.int16).astype(np.int64)
    ai = ls + (hi & 1) + (hi >> 1)
    a = ai.astype(np.int16).astype(np.uint16)
    b = (ai - hi).astype(np.int16).astype(np.uint16)
    return a, b


def _wdec16(l, h):
    m = l.astype(np.int64)
    d = h.astype(np.int64)
    bb = (m - (d >> 1)) & _MOD_MASK
    aa = (d + bb - _A_OFFSET) & _MOD_MASK
    return aa.astype(np.uint16), bb.astype(np.uint16)


def _wav2_decode(a, max_value):
    """In-place inverse 2D wavelet transform on (ny, nx) uint16 plane."""
    ny, nx = a.shape
    wdec = _wdec14 if max_value < (1 << 14) else _wdec16
    n = min(nx, ny)
    p = 1
    while p <= n:
        p <<= 1
    p >>= 1
    p2 = p
    p >>= 1
    while p >= 1:
        ys = np.arange(0, ny - p2 + 1, p2) if ny >= p2 else np.zeros(0, int)
        xs = np.arange(0, nx - p2 + 1, p2) if nx >= p2 else np.zeros(0, int)
        leftover_y = (ys[-1] + p2) if ys.size else 0
        leftover_x = (xs[-1] + p2) if xs.size else 0
        if ys.size and xs.size:
            Y, X = np.meshgrid(ys, xs, indexing='ij')
            a00, a01 = a[Y, X], a[Y, X + p]
            a10, a11 = a[Y + p, X], a[Y + p, X + p]
            i00, i10 = wdec(a00, a10)
            i01, i11 = wdec(a01, a11)
            r00, r01 = wdec(i00, i01)
            r10, r11 = wdec(i10, i11)
            a[Y, X], a[Y, X + p] = r00, r01
            a[Y + p, X], a[Y + p, X + p] = r10, r11
        if (nx & p) and ys.size:
            # leftover column: vertical pairs only
            i00, b = wdec(a[ys, leftover_x], a[ys + p, leftover_x])
            a[ys, leftover_x], a[ys + p, leftover_x] = i00, b
        if (ny & p) and xs.size:
            # leftover row: horizontal pairs only
            i00, b = wdec(a[leftover_y, xs], a[leftover_y, xs + p])
            a[leftover_y, xs], a[leftover_y, xs + p] = i00, b
        p2 = p
        p >>= 1
    return a


def _reverse_lut_from_bitmap(bitmap):
    bits = np.unpackbits(bitmap, bitorder='little')
    idx = np.nonzero(bits)[0]
    if idx.size == 0 or idx[0] != 0:
        idx = np.concatenate([[0], idx])
    lut = np.zeros(1 << 16, np.uint16)
    lut[:idx.size] = idx.astype(np.uint16)
    return lut, idx.size - 1


def _piz_uncompress(data, channels, width, nlines):
    r = _Reader(data)
    min_nz, max_nz = struct.unpack_from('<HH', data, 0)
    r.p = 4
    bitmap = np.zeros(8192, np.uint8)
    if min_nz <= max_nz:
        bitmap[min_nz:max_nz + 1] = np.frombuffer(
            r.bytes(max_nz - min_nz + 1), np.uint8)
    lut, max_value = _reverse_lut_from_bitmap(bitmap)
    length = r.i32()
    huf_data = r.bytes(length)

    nraw = 0
    plane_meta = []
    for (_name, ptype, _xs, _ys) in channels:
        if ptype != PT_HALF:
            raise ValueError("PIZ reader supports half channels only")
        plane_meta.append((nlines, width))
        nraw += nlines * width
    tmp = _huf_uncompress(bytes(huf_data), nraw)

    planes = []
    off = 0
    for (ny, nx) in plane_meta:
        plane = tmp[off:off + ny * nx].reshape(ny, nx).copy()
        off += ny * nx
        _wav2_decode(plane, max_value)
        planes.append(np.ascontiguousarray(lut[plane]))
    return planes


# ---------------------------------------------------------------------------
# Public reader
# ---------------------------------------------------------------------------

def read_exr(path):
    """Read a scanline EXR. Returns (img, channel_names) where img is
    (H, W, C) float32 with channels ordered R,G,B[,A] when present,
    otherwise file order."""
    with open(path, 'rb') as f:
        data = f.read()
    r = _Reader(data)
    if r.u32() != MAGIC:
        raise ValueError(f"not an EXR file: {path}")
    version = r.u32()
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    if version & 0x1000 or version & 0x800:
        raise ValueError("multi-part/deep EXR not supported")
    attrs = _read_header(r)

    channels = _parse_channels(attrs['channels'][1])
    compression = attrs['compression'][1][0]
    xmin, ymin, xmax, ymax = struct.unpack('<iiii', attrs['dataWindow'][1])
    width = xmax - xmin + 1
    height = ymax - ymin + 1
    if compression not in LINES_PER_BLOCK:
        raise ValueError(f"unsupported EXR compression {compression}")
    lpb = LINES_PER_BLOCK[compression]
    nblocks = (height + lpb - 1) // lpb

    # skip offset table; blocks follow sequentially
    r.bytes(8 * nblocks)

    out = {name: np.zeros((height, width), np.float32)
           for (name, _pt, _xs, _ys) in channels}
    bytes_per_line = sum(width * PT_SIZE[pt] for (_n, pt, _xs, _ys) in channels)

    for _b in range(nblocks):
        y = r.i32() - ymin
        size = r.i32()
        block = bytes(r.bytes(size))
        nlines = min(lpb, height - y)
        raw_size = bytes_per_line * nlines

        if compression == CT_PIZ:
            if size >= raw_size:
                _fill_from_scanlines(out, channels, block, y, nlines, width)
            else:
                planes = _piz_uncompress(block, channels, width, nlines)
                for (name, _pt, _xs, _ys), plane in zip(channels, planes):
                    out[name][y:y + nlines] = plane.view(np.float16).astype(
                        np.float32)
            continue

        if compression in (CT_ZIP, CT_ZIPS):
            raw = zlib.decompress(block) if size < raw_size else block
            if size < raw_size:
                raw = _reconstruct(raw)
        elif compression == CT_RLE:
            raw = _reconstruct(_rle_decode(block)) if size < raw_size else block
        else:  # NONE
            raw = block
        _fill_from_scanlines(out, channels, raw, y, nlines, width)

    names = [c[0] for c in channels]
    order = [n for n in ('R', 'G', 'B', 'A') if n in names]
    if not order:
        order = names
    img = np.stack([out[n] for n in order], axis=-1)
    return img, order


def _fill_from_scanlines(out, channels, raw, y0, nlines, width):
    """Scatter scanline-interleaved channel data into per-channel planes."""
    pos = 0
    for ln in range(nlines):
        for (name, pt, _xs, _ys) in channels:
            nb = width * PT_SIZE[pt]
            row = np.frombuffer(raw[pos:pos + nb], PT_DTYPE[pt])
            out[name][y0 + ln] = row.astype(np.float32)
            pos += nb


# ---------------------------------------------------------------------------
# Public writer (ZIP, half RGB)
# ---------------------------------------------------------------------------

def _attr(name, typ, val):
    return name.encode() + b'\0' + typ.encode() + b'\0' + \
        struct.pack('<i', len(val)) + val


def write_exr(path, img):
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[:, :, None].repeat(3, axis=2)
    h, w, c = img.shape
    assert c == 3, "write_exr expects RGB"
    chan_names = ['B', 'G', 'R']  # alphabetical, as required by the format
    chan_data = {'R': img[:, :, 0], 'G': img[:, :, 1], 'B': img[:, :, 2]}

    chlist = b''
    for n in chan_names:
        chlist += n.encode() + b'\0' + struct.pack('<i', PT_HALF) + \
            b'\0\0\0\0' + struct.pack('<ii', 1, 1)
    chlist += b'\0'

    header = b''
    header += _attr('channels', 'chlist', chlist)
    header += _attr('compression', 'compression', bytes([CT_ZIP]))
    box = struct.pack('<iiii', 0, 0, w - 1, h - 1)
    header += _attr('dataWindow', 'box2i', box)
    header += _attr('displayWindow', 'box2i', box)
    header += _attr('lineOrder', 'lineOrder', b'\0')
    header += _attr('pixelAspectRatio', 'float', struct.pack('<f', 1.0))
    header += _attr('screenWindowCenter', 'v2f', struct.pack('<ff', 0, 0))
    header += _attr('screenWindowWidth', 'float', struct.pack('<f', 1.0))
    header += b'\0'

    lpb = LINES_PER_BLOCK[CT_ZIP]
    nblocks = (h + lpb - 1) // lpb
    blocks = []
    for b in range(nblocks):
        y = b * lpb
        nlines = min(lpb, h - y)
        raw = bytearray()
        for ln in range(nlines):
            for n in chan_names:
                raw += chan_data[n][y + ln].astype('<f2').tobytes()
        comp = zlib.compress(_deconstruct(bytes(raw)))
        if len(comp) >= len(raw):
            comp = bytes(raw)
        blocks.append((y, comp))

    with open(path, 'wb') as f:
        f.write(struct.pack('<II', MAGIC, 2))
        f.write(header)
        offset = 4 + 4 + len(header) + 8 * nblocks
        for (_y, comp) in blocks:
            f.write(struct.pack('<Q', offset))
            offset += 8 + len(comp)
        for (y, comp) in blocks:
            f.write(struct.pack('<ii', y, len(comp)))
            f.write(comp)

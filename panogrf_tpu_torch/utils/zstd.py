"""Zstandard decompression (RFC 8878) in numpy and the standard library.

The JAX package's orbax checkpoints store every array chunk and every
OCDBT node as a zstd frame; the port reads them without a zstd module.
Everything in RFC 8878 but dictionaries is handled: single-segment and
windowed frames, with or without ``Frame_Content_Size``; skippable frames
and frames concatenated one after another; raw, RLE and compressed blocks;
raw, RLE, compressed and treeless literals in 1 or 4 streams, with Huffman
weights stored directly or FSE-compressed; sequences in predefined, RLE,
FSE-compressed and repeat mode; the three repeat offsets; matches into
earlier blocks of the frame.  A frame with the content-checksum flag is
checked with XXH64.  A dictionary ID, a reserved bit, truncated or corrupt
input raises ``ValueError`` naming the byte offset.

``decompress_many(buffers)`` decodes several inputs in three passes:

(a) a serial parse of every block (headers, Huffman and FSE tables, and
    the FSE decoding of the sequences);
(b) the Huffman streams of every block of every input decoded in
    lockstep, one numpy step per symbol across all streams, by lookup on
    an 11-bit window (zstd's longest Huffman code), each stream read
    backwards from its final 1-bit;
(c) the sequences executed as slice copies into each frame's output.

Pass (b) is where a float checkpoint's bytes go (its literals are nearly
all of it), so its cost per step is spread over every stream of a call.
"""

from __future__ import annotations

import numpy as np

FRAME_MAGIC = 0xFD2FB528
_SKIPPABLE_MASK = 0xFFFFFFF0
_SKIPPABLE_MAGIC = 0x184D2A50
_MAX_BLOCK = 1 << 17
_HUF_BITS = 11                  # zstd's longest Huffman code
_HUF_TABLE = 1 << _HUF_BITS
# stream bytes decoded per lockstep group (bounds pass (b)'s memory)
_GROUP_BYTES = 24 << 20
_PAD = 32                       # zero bytes before a sequence bitstream

_LL_BASE = list(range(16)) + [16, 18, 20, 22, 24, 28, 32, 40, 48, 64, 128,
                              256, 512, 1024, 2048, 4096, 8192, 16384,
                              32768, 65536]
_LL_BITS = [0] * 16 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 6, 7, 8, 9, 10, 11, 12,
                       13, 14, 15, 16]
_ML_BASE = list(range(3, 35)) + [35, 37, 39, 41, 43, 47, 51, 59, 67, 83,
                                 99, 131, 259, 515, 1027, 2051, 4099, 8195,
                                 16387, 32771, 65539]
_ML_BITS = [0] * 32 + [1, 1, 1, 1, 2, 2, 3, 3, 4, 4, 5, 7, 8, 9, 10, 11,
                       12, 13, 14, 15, 16]
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1,
                2, 2, 2, 2, 2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1,
                -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, -1, -1,
                -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1], 5)
# (largest symbol, largest accuracy log) of the three sequence codes
_LL_LIMITS, _OF_LIMITS, _ML_LIMITS = (35, 9), (31, 8), (52, 9)


def _corrupt(what: str, offset: int) -> ValueError:
    return ValueError(f"zstd: {what} at byte {offset}")


def _need(pos: int, n: int, end: int, what: str) -> None:
    if n < 0 or pos + n > end:
        raise _corrupt(f"truncated {what}", pos)


# -- FSE ---------------------------------------------------------------------

def _build_fse(norm: list, log: int) -> tuple:
    """Decoding table of a normalised distribution: per state, the symbol,
    the bits to read and the base of the next state (three lists)."""
    size = 1 << log
    sym = [0] * size
    high = size - 1
    nxt = [0] * len(norm)
    for s, c in enumerate(norm):
        if c == -1:
            sym[high] = s
            high -= 1
            nxt[s] = 1
        else:
            nxt[s] = c
    step = (size >> 1) + (size >> 3) + 3
    mask = size - 1
    pos = 0
    for s, c in enumerate(norm):
        for _ in range(c if c > 0 else 0):
            sym[pos] = s
            pos = (pos + step) & mask
            while pos > high:
                pos = (pos + step) & mask
    if pos != 0:
        raise ValueError("zstd: FSE distribution does not fill its table")
    nbits, base = [0] * size, [0] * size
    for u in range(size):
        s = sym[u]
        n = nxt[s]
        nxt[s] = n + 1
        nb = log - (n.bit_length() - 1)
        nbits[u] = nb
        base[u] = (n << nb) - size
    return sym, nbits, base


def _rle_fse(symbol: int) -> tuple:
    return [symbol], [0], [0]


_PREDEFINED = {}


def _predefined(which: str) -> tuple:
    if not _PREDEFINED:
        for name, (norm, log) in (("ll", _LL_DEFAULT), ("of", _OF_DEFAULT),
                                  ("ml", _ML_DEFAULT)):
            _PREDEFINED[name] = _build_fse(norm, log)
    return _PREDEFINED[which]


def _read_fse_table(src, pos: int, end: int, max_symbol: int,
                    max_log: int) -> tuple:
    """A table description at ``pos`` -> (decoding table, accuracy log,
    position after it)."""
    _need(pos, 1, end, "FSE table description")
    start = pos
    # the header is a forward little-endian bitstream of at most
    # (max_symbol + 1) * (max_log + 2) bits plus repeat flags
    avail = min(end - pos, 512)
    bits = int.from_bytes(src[pos:pos + avail], "little")
    nbits_total = 8 * avail
    log = (bits & 15) + 5
    if log > max_log:
        raise _corrupt(f"FSE accuracy log {log} above {max_log}", pos)
    bp = 4
    remaining = (1 << log) + 1
    threshold = 1 << log
    nb = log + 1
    norm = []
    prev0 = False
    while remaining > 1 and len(norm) <= max_symbol:
        if prev0:
            while True:
                r = (bits >> bp) & 3
                bp += 2
                norm.extend([0] * r)
                if r != 3:
                    break
            if len(norm) > max_symbol:
                break
        mx = (2 * threshold - 1) - remaining
        low = (bits >> bp) & (threshold - 1)
        if low < mx:
            count = low
            bp += nb - 1
        else:
            count = (bits >> bp) & (2 * threshold - 1)
            if count >= threshold:
                count -= mx
            bp += nb
        count -= 1
        remaining -= -count if count < 0 else count
        norm.append(count)
        prev0 = count == 0
        while remaining < threshold:
            nb -= 1
            threshold >>= 1
        if bp > nbits_total:
            raise _corrupt("truncated FSE table description", start)
    if remaining != 1 or len(norm) > max_symbol + 1 or bp > nbits_total:
        raise _corrupt("corrupt FSE table description", start)
    return _build_fse(norm, log), log, start + ((bp + 7) >> 3)


# -- Huffman -----------------------------------------------------------------

def _fse_weights(src, pos: int, size: int) -> list:
    """Huffman weights compressed with FSE (two interleaved states)."""
    end = pos + size
    (sym, nbits, base), log, p = _read_fse_table(src, pos, end, 255, 6)
    if p >= end:
        raise _corrupt("empty Huffman weight stream", p)
    data = bytes(_PAD) + bytes(src[p:end])
    last = data[-1]
    if last == 0:
        raise _corrupt("Huffman weight stream without end mark", end - 1)
    bit = 8 * (len(data) - 1) + last.bit_length() - 1
    floor = 8 * _PAD
    big = int.from_bytes(data, "little")

    def read(n):
        nonlocal bit
        bit -= n
        if n == 0:
            return 0
        return (big >> bit) & ((1 << n) - 1) if bit >= 0 else 0

    s1 = read(log)
    s2 = read(log)
    out = []
    while True:
        if len(out) > 254:
            raise _corrupt("too many Huffman weights", pos)
        out.append(sym[s1])
        s1 = base[s1] + read(nbits[s1])
        if bit < floor:
            out.append(sym[s2])
            break
        out.append(sym[s2])
        s2 = base[s2] + read(nbits[s2])
        if bit < floor:
            out.append(sym[s1])
            break
    return out


def _read_huffman(src, pos: int, end: int) -> tuple:
    """A Huffman tree description at ``pos`` -> (an 11-bit decoding table
    of ``symbol | bits << 8`` as uint16, position after it)."""
    _need(pos, 1, end, "Huffman tree description")
    head = src[pos]
    if head < 128:
        _need(pos + 1, head, end, "Huffman weights")
        weights = _fse_weights(src, pos + 1, head)
        after = pos + 1 + head
    else:
        n = head - 127
        nbytes = (n + 1) // 2
        _need(pos + 1, nbytes, end, "Huffman weights")
        weights = []
        for b in src[pos + 1:pos + 1 + nbytes]:
            weights += [b >> 4, b & 15]
        weights = weights[:n]
        after = pos + 1 + nbytes
    if any(w > _HUF_BITS for w in weights):
        raise _corrupt("Huffman weight above 11", pos)
    total = sum((1 << w) >> 1 for w in weights)
    if total == 0:
        raise _corrupt("Huffman weights all zero", pos)
    max_bits = total.bit_length()
    rest = (1 << max_bits) - total
    if rest & (rest - 1) or max_bits > _HUF_BITS:
        raise _corrupt("Huffman weights do not sum to a power of two", pos)
    weights.append(rest.bit_length())
    rank_start = [0] * (max_bits + 2)
    count = [0] * (max_bits + 2)
    for w in weights:
        count[w] += 1
    nxt = 0
    for w in range(1, max_bits + 1):
        rank_start[w] = nxt
        nxt += count[w] << (w - 1)
    table = np.empty(1 << max_bits, np.uint16)
    for s, w in enumerate(weights):
        if w:
            n = (1 << w) >> 1
            st = rank_start[w]
            table[st:st + n] = s | ((max_bits + 1 - w) << 8)
            rank_start[w] = st + n
    return np.repeat(table, 1 << (_HUF_BITS - max_bits)), after


# -- frames ------------------------------------------------------------------

class _Literals:
    """A compressed block's literals: ``kind`` "raw" (``data``), "rle"
    (``byte`` x ``size``) or "huf" (streams ``first`` .. ``first + n``)."""
    __slots__ = ("kind", "data", "byte", "size", "first", "n")

    def __init__(self, kind, size, data=None, byte=0, first=0, n=0):
        self.kind, self.size, self.data, self.byte = kind, size, data, byte
        self.first, self.n = first, n


class _Frame:
    __slots__ = ("blocks", "content_size", "checksum", "offset")

    def __init__(self, offset):
        self.blocks, self.content_size, self.checksum = [], None, None
        self.offset = offset


class _Parser:
    """Pass (a): parses frames and collects the Huffman streams of every
    input of one ``decompress_many`` call."""

    def __init__(self):
        # per stream: (input index, start, length, symbols, table index)
        self.streams = []
        self.tables = []

    def parse(self, index: int, src: bytes) -> list:
        frames, pos, end = [], 0, len(src)
        while pos < end:
            _need(pos, 4, end, "frame magic")
            magic = int.from_bytes(src[pos:pos + 4], "little")
            if magic & _SKIPPABLE_MASK == _SKIPPABLE_MAGIC:
                _need(pos + 4, 4, end, "skippable frame size")
                size = int.from_bytes(src[pos + 4:pos + 8], "little")
                _need(pos + 8, size, end, "skippable frame")
                pos += 8 + size
                continue
            if magic != FRAME_MAGIC:
                raise _corrupt(f"not a zstd frame (magic {magic:#010x})",
                               pos)
            frame, pos = self._frame(index, src, pos, end)
            frames.append(frame)
        return frames

    def _frame(self, index, src, pos, end):
        frame = _Frame(pos)
        _need(pos + 4, 1, end, "frame header")
        fhd = src[pos + 4]
        p = pos + 5
        fcs_flag, single = fhd >> 6, (fhd >> 5) & 1
        if fhd & 8:
            raise _corrupt("reserved bit set in frame header", pos + 4)
        checksum, did_flag = (fhd >> 2) & 1, fhd & 3
        window = None
        if not single:
            _need(p, 1, end, "window descriptor")
            wd = src[p]
            wbase = 1 << (10 + (wd >> 3))
            window = wbase + (wbase >> 3) * (wd & 7)
            p += 1
        did_size = (0, 1, 2, 4)[did_flag]
        _need(p, did_size, end, "dictionary ID")
        if did_size and int.from_bytes(src[p:p + did_size], "little"):
            raise _corrupt("frame needs a dictionary (not supported)", p)
        p += did_size
        fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
        _need(p, fcs_size, end, "frame content size")
        if fcs_size:
            fcs = int.from_bytes(src[p:p + fcs_size], "little")
            frame.content_size = fcs + 256 if fcs_size == 2 else fcs
            p += fcs_size
        if window is None:
            window = frame.content_size
        block_max = min(window, _MAX_BLOCK)
        huf = None                      # the previous Huffman table
        fse = {"ll": None, "of": None, "ml": None}
        reps = [1, 4, 8]
        while True:
            _need(p, 3, end, "block header")
            bh = int.from_bytes(src[p:p + 3], "little")
            last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
            p += 3
            if btype == 3:
                raise _corrupt("reserved block type", p - 3)
            if bsize > block_max:
                raise _corrupt(f"block of {bsize} bytes above its maximum "
                               f"{block_max}", p - 3)
            if btype == 0:
                _need(p, bsize, end, "raw block")
                frame.blocks.append(("raw", src[p:p + bsize]))
                p += bsize
            elif btype == 1:
                _need(p, 1, end, "RLE block")
                frame.blocks.append(("rle", src[p], bsize))
                p += 1
            else:
                _need(p, bsize, end, "compressed block")
                lits, seqs, huf = self._block(index, src, p, p + bsize, huf,
                                              fse, reps)
                frame.blocks.append(("cmp", lits, seqs))
                p += bsize
            if last:
                break
        if checksum:
            _need(p, 4, end, "content checksum")
            frame.checksum = int.from_bytes(src[p:p + 4], "little")
            p += 4
        return frame, p

    def _block(self, index, src, pos, end, huf, fse, reps):
        b0 = src[pos]
        ltype, sf = b0 & 3, (b0 >> 2) & 3
        if ltype < 2:
            if sf in (0, 2):
                size, hl = b0 >> 3, 1
            elif sf == 1:
                _need(pos, 2, end, "literals header")
                size, hl = (b0 >> 4) + (src[pos + 1] << 4), 2
            else:
                _need(pos, 3, end, "literals header")
                size = (b0 >> 4) + (src[pos + 1] << 4) + (src[pos + 2] << 12)
                hl = 3
            p = pos + hl
            if size > _MAX_BLOCK:
                raise _corrupt("literals above the block maximum", pos)
            if ltype == 0:
                _need(p, size, end, "raw literals")
                lits = _Literals("raw", size, data=src[p:p + size])
                p += size
            else:
                _need(p, 1, end, "RLE literals")
                lits = _Literals("rle", size, byte=src[p])
                p += 1
        else:
            hl = (3, 3, 4, 5)[sf]
            _need(pos, hl, end, "literals header")
            v = int.from_bytes(src[pos:pos + hl], "little") >> 4
            sbits = (10, 10, 14, 18)[sf]
            size, csize = v & ((1 << sbits) - 1), v >> sbits
            nstreams = 1 if sf == 0 else 4
            p = pos + hl
            if size > _MAX_BLOCK:
                raise _corrupt("literals above the block maximum", pos)
            _need(p, csize, end, "compressed literals")
            lend = p + csize
            if ltype == 2:
                table, q = _read_huffman(src, p, lend)
                self.tables.append(table)
                huf = len(self.tables) - 1
            else:
                if huf is None:
                    raise _corrupt("treeless literals without a previous "
                                   "Huffman table", pos)
                q = p
            first = len(self.streams)
            if nstreams == 1:
                self._stream(index, q, lend - q, size, huf)
            else:
                _need(q, 6, lend, "jump table")
                s1, s2, s3 = (int.from_bytes(src[q + i:q + i + 2], "little")
                              for i in (0, 2, 4))
                q += 6
                s4 = lend - q - s1 - s2 - s3
                seg = (size + 3) // 4
                n4 = size - 3 * seg
                if s4 < 1 or n4 < 0:
                    raise _corrupt("corrupt jump table", q - 6)
                for ln, ns in ((s1, seg), (s2, seg), (s3, seg), (s4, n4)):
                    self._stream(index, q, ln, ns, huf)
                    q += ln
            lits = _Literals("huf", size, first=first, n=nstreams)
            p = lend
        seqs = self._sequences(src, p, end, fse, reps)
        return lits, seqs, huf

    def _stream(self, index, start, length, nsym, table):
        if length < 1:
            raise _corrupt("empty Huffman stream", start)
        self.streams.append((index, start, length, nsym, table))

    def _sequences(self, src, pos, end, fse, reps):
        _need(pos, 1, end, "sequences header")
        b0 = src[pos]
        if b0 == 0:
            if pos + 1 != end:
                raise _corrupt("bytes after an empty sequences section",
                               pos + 1)
            return None
        if b0 < 128:
            nseq, p = b0, pos + 1
        elif b0 < 255:
            _need(pos, 2, end, "sequences header")
            nseq, p = ((b0 - 128) << 8) + src[pos + 1], pos + 2
        else:
            _need(pos, 3, end, "sequences header")
            nseq = src[pos + 1] + (src[pos + 2] << 8) + 0x7F00
            p = pos + 3
        _need(p, 1, end, "symbol compression modes")
        modes = src[p]
        if modes & 3:
            raise _corrupt("reserved bits in symbol compression modes", p)
        p += 1
        for name, shift, limits in (("ll", 6, _LL_LIMITS),
                                    ("of", 4, _OF_LIMITS),
                                    ("ml", 2, _ML_LIMITS)):
            mode = (modes >> shift) & 3
            if mode == 0:
                fse[name] = (_predefined(name),
                             {"ll": 6, "of": 5, "ml": 6}[name])
            elif mode == 1:
                _need(p, 1, end, "RLE sequence code")
                if src[p] > limits[0]:
                    raise _corrupt("RLE sequence code out of range", p)
                fse[name] = (_rle_fse(src[p]), 0)
                p += 1
            elif mode == 2:
                table, log, p = _read_fse_table(src, p, end, *limits)
                fse[name] = (table, log)
            elif fse[name] is None:
                raise _corrupt("repeat sequence table without a previous "
                               "one", p)
        return _decode_sequences(src, p, end, nseq, fse, reps)


def _decode_sequences(src, pos, end, nseq, fse, reps):
    """FSE-decodes ``nseq`` sequences -> (literal lengths, match lengths,
    offsets) lists, the repeat offsets resolved (``reps`` updated)."""
    if pos >= end:
        raise _corrupt("empty sequence bitstream", pos)
    data = bytes(_PAD) + bytes(src[pos:end])
    last = data[-1]
    if last == 0:
        raise _corrupt("sequence bitstream without end mark", end - 1)
    floor = 8 * _PAD
    bit = 8 * (len(data) - 1) + last.bit_length() - 1
    (lsym, lnb, lbase), llog = fse["ll"]
    (osym, onb, obase), olog = fse["of"]
    (msym, mnb, mbase), mlog = fse["ml"]
    # a 16-byte window holds every bit one sequence reads (at most 89)
    b = (bit + 7) >> 3
    w = int.from_bytes(data[b - 16:b], "little")
    rel = bit - 8 * (b - 16)
    rel -= llog
    ls = (w >> rel) & ((1 << llog) - 1)
    rel -= olog
    os_ = (w >> rel) & ((1 << olog) - 1)
    rel -= mlog
    ms = (w >> rel) & ((1 << mlog) - 1)
    bit = 8 * (b - 16) + rel
    lls, mls, offs = [0] * nseq, [0] * nseq, [0] * nseq
    r1, r2, r3 = reps
    llb, llx, mlb, mlx = _LL_BASE, _LL_BITS, _ML_BASE, _ML_BITS
    for i in range(nseq):
        if bit < floor:
            raise _corrupt("sequence bitstream overread", pos)
        b = (bit + 7) >> 3
        w = int.from_bytes(data[b - 16:b], "little")
        rel = bit - 8 * (b - 16)
        oc, mc, lc = osym[os_], msym[ms], lsym[ls]
        rel -= oc
        ov = (1 << oc) + ((w >> rel) & ((1 << oc) - 1))
        n = mlx[mc]
        rel -= n
        ml = mlb[mc] + ((w >> rel) & ((1 << n) - 1))
        n = llx[lc]
        rel -= n
        ll = llb[lc] + ((w >> rel) & ((1 << n) - 1))
        if i + 1 < nseq:
            n = lnb[ls]
            rel -= n
            ls = lbase[ls] + ((w >> rel) & ((1 << n) - 1))
            n = mnb[ms]
            rel -= n
            ms = mbase[ms] + ((w >> rel) & ((1 << n) - 1))
            n = onb[os_]
            rel -= n
            os_ = obase[os_] + ((w >> rel) & ((1 << n) - 1))
        bit = 8 * (b - 16) + rel
        if ov > 3:
            off = ov - 3
            r1, r2, r3 = off, r1, r2
        else:
            k = ov - (ll != 0)
            if k == 0:
                off = r1
            elif k == 1:
                off = r2
                r1, r2 = off, r1
            elif k == 2:
                off = r3
                r1, r2, r3 = off, r1, r2
            else:
                off = r1 - 1
                if off == 0:
                    raise _corrupt("repeat offset of 0", pos)
                r1, r2, r3 = off, r1, r2
        lls[i], mls[i], offs[i] = ll, ml, off
    if bit != floor:
        raise _corrupt("sequence bitstream not consumed exactly", pos)
    reps[:] = [r1, r2, r3]
    return lls, mls, offs


# -- pass (b): Huffman streams in lockstep ------------------------------------

def _decode_streams(srcs: list, streams: list, tables: list) -> list:
    """Every Huffman stream -> its literals (a list of uint8 arrays, in
    the order of ``streams``)."""
    if not streams:
        return []
    nsym = np.array([s[3] for s in streams], np.int64)
    order = np.argsort(-nsym, kind="stable")
    table_all = np.concatenate(tables)
    out = [None] * len(streams)
    group, size = [], 0
    for i in order.tolist():
        group.append(i)
        size += streams[i][2]
        if size >= _GROUP_BYTES:
            _decode_group(srcs, streams, table_all, group, out)
            group, size = [], 0
    if group:
        _decode_group(srcs, streams, table_all, group, out)
    return out


def _decode_group(srcs, streams, table_all, group, out):
    """Streams ``group`` (longest first) decoded in lockstep."""
    n = len(group)
    gap = 2                       # zero bytes before each stream: 16 bits
    lens = np.array([streams[i][2] for i in group], np.int64)
    nsym = np.array([streams[i][3] for i in group], np.int64)
    starts = np.zeros(n, np.int64)
    starts[1:] = np.cumsum(lens + gap)[:-1]
    starts += gap
    buf = np.zeros(int(starts[-1] + lens[-1]) + 4, np.uint8)
    marks = np.empty(n, np.int64)
    for j, i in enumerate(group):
        si, st, ln = streams[i][:3]
        seg = np.frombuffer(srcs[si], np.uint8, ln, st)
        buf[starts[j]:starts[j] + ln] = seg
        last = int(seg[-1])
        if last == 0:
            raise _corrupt("Huffman stream without end mark", st + ln - 1)
        marks[j] = last.bit_length() - 1
    words = (buf[:-2].astype(np.uint32) | (buf[1:-1].astype(np.uint32) << 8)
             | (buf[2:].astype(np.uint32) << 16))
    # bit address of each stream's next window: 11 bits under its cursor
    cursor = 8 * (starts + lens - 1) + marks - _HUF_BITS
    floor = 8 * starts - _HUF_BITS
    toff = np.array([streams[i][4] for i in group], np.int64) * _HUF_TABLE
    steps = int(nsym[0])
    sym = np.empty((steps, n), np.uint16)
    # streams still decoding at step t form a prefix (longest first)
    ends = np.searchsorted(-nsym, -np.arange(steps), side="left")
    try:
        for t in range(steps):
            k = ends[t]
            c = cursor[:k]
            v = (words[c >> 3] >> (c & 7)) & (_HUF_TABLE - 1)
            e = table_all[toff[:k] + v]
            sym[t, :k] = e
            c -= e >> 8
    except IndexError:          # a corrupt stream read far below its start
        pass
    if (cursor != floor).any():
        j = int(np.nonzero(cursor != floor)[0][0])
        si, st = streams[group[j]][:2]
        raise _corrupt("Huffman stream not consumed exactly", st)
    lit = sym.T.astype(np.uint8, order="C")     # rows: one stream each
    for j, i in enumerate(group):
        out[i] = lit[j, :nsym[j]]


# -- pass (c) and the API ----------------------------------------------------

def _execute(frame: _Frame, literals: list) -> bytearray:
    out = bytearray()
    for block in frame.blocks:
        kind = block[0]
        if kind == "raw":
            out += block[1]
            continue
        if kind == "rle":
            out += bytes((block[1],)) * block[2]
            continue
        lits, seqs = block[1], block[2]
        if lits.kind == "raw":
            lit = bytes(lits.data)
        elif lits.kind == "rle":
            lit = bytes((lits.byte,)) * lits.size
        else:
            parts = literals[lits.first:lits.first + lits.n]
            lit = b"".join(p.tobytes() for p in parts)
        start = len(out)
        if seqs is None:
            out += lit
        else:
            lp = 0
            for ll, ml, off in zip(*seqs):
                if ll:
                    out += lit[lp:lp + ll]
                    lp += ll
                p = len(out)
                if off > p:
                    raise _corrupt(f"match offset {off} before the frame's "
                                   f"start", frame.offset)
                s = p - off
                if off >= ml:
                    out += out[s:s + ml]
                else:
                    pat = out[s:p]
                    out += (pat * (ml // off + 1))[:ml]
            if lp > len(lit):
                raise _corrupt("sequences use more literals than the "
                               "block has", frame.offset)
            out += lit[lp:]
        if len(out) - start > _MAX_BLOCK:
            raise _corrupt("block decodes above 128 KB", frame.offset)
    if frame.content_size is not None and len(out) != frame.content_size:
        raise _corrupt(f"frame decodes to {len(out)} bytes, its header "
                       f"says {frame.content_size}", frame.offset)
    if frame.checksum is not None:
        got = xxh64(out) & 0xFFFFFFFF
        if got != frame.checksum:
            raise _corrupt(f"content checksum {got:#010x} != "
                           f"{frame.checksum:#010x}", frame.offset)
    return out


def decompress_many(buffers) -> list:
    """Each buffer (bytes-like: one or more frames, skippable frames
    allowed) -> its decompressed bytes (a ``bytearray``), decoding the
    Huffman streams of all buffers together."""
    srcs = [bytes(b) for b in buffers]
    parser = _Parser()
    frames = [parser.parse(i, s) for i, s in enumerate(srcs)]
    literals = _decode_streams(srcs, parser.streams, parser.tables)
    outs = []
    for fl in frames:
        parts = [_execute(f, literals) for f in fl]
        outs.append(parts[0] if len(parts) == 1
                    else bytearray(b"".join(parts)))
    return outs


def decompress(data) -> bytearray:
    """One buffer's frames -> the decompressed bytes."""
    return decompress_many([data])[0]


# -- XXH64 -------------------------------------------------------------------

_M64 = (1 << 64) - 1
_P1, _P2 = 11400714785074694791, 14029467366897019727
_P3, _P4, _P5 = 1609587929392839161, 9650029242287828579, 2870177450012600261


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return (_rotl((acc + lane * _P2) & _M64, 31) * _P1) & _M64


def xxh64(data, seed: int = 0) -> int:
    """XXH64 of ``data`` (the hash zstd's content checksum truncates)."""
    data = bytes(data)
    n = len(data)
    p = 0
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        stripes = n // 32
        lanes = np.frombuffer(data, "<u8", stripes * 4).tolist()
        for i in range(0, 4 * stripes, 4):
            v1 = _round(v1, lanes[i])
            v2 = _round(v2, lanes[i + 1])
            v3 = _round(v3, lanes[i + 2])
            v4 = _round(v4, lanes[i + 3])
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
             + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            h = ((h ^ _round(0, v)) * _P1 + _P4) & _M64
        p = 32 * stripes
    else:
        h = (seed + _P5) & _M64
    h = (h + n) & _M64
    while p + 8 <= n:
        h ^= _round(0, int.from_bytes(data[p:p + 8], "little"))
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        p += 8
    if p + 4 <= n:
        h ^= (int.from_bytes(data[p:p + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        p += 4
    while p < n:
        h ^= (data[p] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        p += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h

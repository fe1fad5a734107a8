"""HDF5 reading and writing without h5py, to h5py's arrays.

gd3d reads MegaDepth's depth maps and the HDF5 stereo / flow ground truth
(`.h5`, `.hdf5`, `.flo5`) with h5py and writes `.flo5` flows with it
(gd3d/data/preprocess_mvs.py, gd3d/data/flowio.py); the card's machine has
no h5py. `read_dataset(path, name)` gives np.asarray(h5py.File(path)[name])
for one numeric N-d dataset as h5py 3.14 (HDF5 1.14) writes it, at its
default file format and with libver="latest":

  * superblocks v0-v3; object headers v1 and v2 (with their continuation
    blocks); groups as symbol tables (v1 B-tree, SNOD nodes, local heap) or
    compact link messages, walked along the dataset's path;
  * IEEE float16/32/64 and 8-64-bit integers in either byte order, returned
    in the stored byte order as h5py returns them;
  * compact, contiguous and chunked layouts (layout messages v3 and v4),
    chunks found through the v1 B-tree or the v4 indices: single chunk,
    implicit, fixed array (paged or not), extensible array and v2 B-tree;
  * the deflate, shuffle and fletcher32 filters (a chunk's filter mask
    honoured, the checksum checked), and the fill value where a chunk was
    never written.

Anything else raises ValueError naming the file and the feature: other
filters (lzf, szip, n-bit, scale-offset), compound, string, enum, array,
reference and variable-length types, virtual or external storage, external
and soft links on the path, and dense (fractal-heap) link storage.

`write_dataset(path, name, array)` writes one dataset in the default file
format (superblock v0, v1 object headers, a symbol-table root group), chunked
along its first axis with the deflate filter at level 5 (gd3d's write_flo5
asks h5py for that level), which h5py reads back equal. Metadata
checksums of the v2 structures are not verified.
"""
from __future__ import annotations

import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from gd3d_torch.data.source import Source, read_source


SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
GZIP_LEVEL = 5  # gd3d's write_flo5 has h5py deflate at level 5
CHUNK_BYTES = 1 << 20  # write_dataset's chunk target
_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
            6: "scaleoffset", 32000: "lzf"}
_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque", 6: "compound",
            7: "reference", 8: "enum", 9: "variable-length", 10: "array"}


def _uint(b: bytes, off: int, n: int) -> int:
    return int.from_bytes(b[off:off + n], "little")


class _File:
    def __init__(self, data: bytes, name: str):
        self.data, self.name = data, name
        base = None
        for off in [0] + [512 << i for i in range(20)]:
            if off + 8 > len(data):
                break
            if data[off:off + 8] == SIGNATURE:
                base = off
                break
        if base is None:
            raise ValueError(f"{name}: not an HDF5 file (no signature)")
        d = data
        v = d[base + 8]
        if v in (0, 1):
            self.so, self.sl = d[base + 13], d[base + 14]
            pos = base + 24 + (4 if v == 1 else 0)
            self.base = self.addr(pos)
            pos += 4 * self.so
            # root group symbol table entry: name offset, object header address
            self.root = self.addr(pos + self.so)
        elif v in (2, 3):
            self.so, self.sl = d[base + 9], d[base + 10]
            pos = base + 12
            self.base = self.addr(pos)
            self.root = self.addr(pos + 3 * self.so)
        else:
            raise ValueError(f"{name}: HDF5 superblock version {v} is not supported")
        if self.so != 8 or self.sl != 8:
            raise ValueError(f"{name}: HDF5 offsets of {self.so} and lengths of {self.sl} "
                             f"bytes are not supported (8 only)")

    def addr(self, pos: int) -> int:
        return _uint(self.data, pos, self.so)

    def at(self, addr: int) -> int:
        if addr == UNDEF or self.base + addr >= len(self.data):
            raise ValueError(f"{self.name}: HDF5 address {addr:#x} outside the file")
        return self.base + addr

    def fail(self, what: str):
        raise ValueError(f"{self.name}: HDF5 {what} is not supported")

    # ---------------------------------------------------------- object headers
    def messages(self, addr: int) -> List[Tuple[int, bytes]]:
        """(type, payload) of every message of the object header at addr,
        continuation blocks followed."""
        d = self.data
        pos = self.at(addr)
        out: List[Tuple[int, bytes]] = []
        blocks: List[Tuple[int, int, bool]] = []
        if d[pos:pos + 4] == b"OHDR":
            flags = d[pos + 5]
            p = pos + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            n = 1 << (flags & 3)
            size = _uint(d, p, n)
            blocks.append((p + n, size, True))
            v2, track = True, bool(flags & 0x04)
        else:
            if d[pos] != 1:
                self.fail(f"object header version {d[pos]}")
            size = _uint(d, pos + 8, 4)
            blocks.append((pos + 16, size, False))
            v2, track = False, False
        while blocks:
            p, size, _ = blocks.pop(0)
            end = p + size
            while p < end:
                if v2:
                    if p + 4 > end:
                        break
                    mtype, msize, mflags = d[p], _uint(d, p + 1, 2), d[p + 3]
                    p += 4 + (2 if track else 0)
                else:
                    if p + 8 > end:
                        break
                    mtype, msize, mflags = _uint(d, p, 2), _uint(d, p + 2, 2), d[p + 4]
                    p += 8
                body = d[p:p + msize]
                p += msize
                if mflags & 0x02:  # a shared message: stored elsewhere
                    self.fail(f"shared object header message (type {mtype})")
                if mtype == 0x10:  # continuation
                    caddr, clen = self.addr_in(body, 0), _uint(body, self.so, self.sl)
                    cpos = self.at(caddr)
                    if v2:
                        if d[cpos:cpos + 4] != b"OCHK":
                            raise ValueError(f"{self.name}: bad HDF5 continuation block")
                        blocks.append((cpos + 4, clen - 8, True))
                    else:
                        blocks.append((cpos, clen, False))
                elif mtype:
                    out.append((mtype, body))
        return out

    def addr_in(self, b: bytes, off: int) -> int:
        return _uint(b, off, self.so)

    # ------------------------------------------------------------------ groups
    def child(self, header: int, name: str) -> int:
        """The object header address of link `name` in the group at header."""
        msgs = self.messages(header)
        for mtype, body in msgs:
            if mtype == 0x11:  # symbol table
                return self._symbol_table_lookup(self.addr_in(body, 0),
                                                 self.addr_in(body, self.so), name)
        for mtype, body in msgs:
            if mtype == 0x02 and self.addr_in(body, 2 + (8 if body[1] & 1 else 0)) != UNDEF:
                self.fail("dense (fractal heap) link storage")
        for mtype, body in msgs:
            if mtype == 0x06:
                link = self._link(body)
                if link[0] == name:
                    if link[1] != 0:
                        self.fail(f"{'soft' if link[1] == 1 else 'external'} link '{name}'")
                    return link[2]
        raise ValueError(f"{self.name}: no object '{name}' in the HDF5 file")

    def _link(self, b: bytes):
        flags = b[1]
        p = 2
        ltype = 0
        if flags & 0x08:
            ltype = b[p]
            p += 1
        if flags & 0x04:
            p += 8
        if flags & 0x10:
            p += 1
        n = 1 << (flags & 3)
        nlen = _uint(b, p, n)
        p += n
        lname = b[p:p + nlen].decode("utf-8", "replace")
        p += nlen
        return lname, ltype, (self.addr_in(b, p) if ltype == 0 else None)

    def _heap_string(self, heap: int, off: int) -> str:
        d = self.data
        hp = self.at(heap)
        if d[hp:hp + 4] != b"HEAP":
            raise ValueError(f"{self.name}: bad HDF5 local heap")
        seg = self.at(self.addr(hp + 8 + 2 * self.sl))
        end = d.index(b"\x00", seg + off)
        return d[seg + off:end].decode("utf-8", "replace")

    def _symbol_table_lookup(self, btree: int, heap: int, name: str) -> int:
        d = self.data
        so = self.so
        stack = [btree]
        while stack:
            p = self.at(stack.pop())
            if d[p:p + 4] == b"TREE":
                level, used = d[p + 5], _uint(d, p + 6, 2)
                q = p + 8 + 2 * so
                for i in range(used):  # key i, child i
                    stack.append(self.addr(q + self.sl + i * (self.sl + so)))
                continue
            if d[p:p + 4] != b"SNOD":
                raise ValueError(f"{self.name}: bad HDF5 group node")
            n = _uint(d, p + 6, 2)
            for i in range(n):
                e = p + 8 + i * (2 * so + 24)
                if self._heap_string(heap, self.addr(e)) == name:
                    return self.addr(e + so)
        raise ValueError(f"{self.name}: no object '{name}' in the HDF5 file")


# ------------------------------------------------------------------ datatype
def _dtype(f: _File, b: bytes) -> np.dtype:
    cls, bits0, size = b[0] & 15, b[1], _uint(b, 4, 4)
    order = ">" if bits0 & 1 else "<"
    if cls == 0:
        if size not in (1, 2, 4, 8) or _uint(b, 8, 2) != 0 or _uint(b, 10, 2) != 8 * size:
            f.fail(f"integer type of {size} bytes with padding bits")
        return np.dtype(f"{order}{'i' if bits0 & 8 else 'u'}{size}")
    if cls == 1:
        ieee = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}.get(size)
        if bits0 & 0x40 or ieee is None:
            f.fail(f"floating-point type of {size} bytes")
        eloc, esize, msize, bias = b[12], b[13], b[15], _uint(b, 16, 4)
        if (eloc, esize, msize, bias) != ieee:
            f.fail(f"non-IEEE floating-point type of {size} bytes")
        return np.dtype(f"{order}f{size}")
    f.fail(f"{_CLASSES.get(cls, f'class {cls}')} datatype")


def _fletcher32(b: bytes) -> int:
    """H5_checksum_fletcher32: big-endian 16-bit words, folded every 360."""
    n = len(b) // 2
    w = np.frombuffer(b[:2 * n], ">u2").astype(np.uint64)
    s1 = s2 = 0
    for i in range(0, n, 360):
        blk = w[i:i + 360]
        c = np.cumsum(blk)
        s2 += len(blk) * s1 + int(c.sum())
        s1 += int(c[-1])
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(b) % 2:
        s1 += b[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return (s2 << 16) | s1


def _unfilter(f: _File, raw: bytes, pipeline, mask: int) -> bytes:
    for i in range(len(pipeline) - 1, -1, -1):
        fid, cdata = pipeline[i]
        if mask & (1 << i):
            continue
        if fid == 1:
            raw = zlib.decompress(raw)
        elif fid == 2:
            es = cdata[0] if cdata else 1
            n = len(raw) // es
            body = np.frombuffer(raw[:n * es], np.uint8).reshape(es, n).T.tobytes()
            raw = body + raw[n * es:]
        elif fid == 3:
            stored = _uint(raw, len(raw) - 4, 4)
            raw = raw[:-4]
            sum_ = _fletcher32(raw)
            swapped = int.from_bytes(sum_.to_bytes(4, "little"), "big")
            if stored not in (sum_, swapped):
                raise ValueError(f"{f.name}: HDF5 fletcher32 checksum mismatch")
        else:
            f.fail(f"{_FILTERS.get(fid, f'filter {fid}')} filter")
    return raw


def _pipeline(f: _File, b: bytes):
    version, n = b[0], b[1]
    p = 8 if version == 1 else 2
    out = []
    for _ in range(n):
        fid = _uint(b, p, 2)
        if version == 1 or fid >= 256:
            nlen = _uint(b, p + 2, 2)
            p += 4
        else:
            nlen = 0
            p += 2
        nvals = _uint(b, p + 2, 2)  # after the flags
        p += 4 + nlen
        vals = [_uint(b, p + 4 * i, 4) for i in range(nvals)]
        p += 4 * nvals + (4 if version == 1 and nvals % 2 else 0)
        if fid not in (1, 2, 3):
            f.fail(f"{_FILTERS.get(fid, f'filter {fid}')} filter")
        out.append((fid, vals))
    return out


def _fill(b: bytes) -> Optional[bytes]:
    version = b[0]
    if version in (1, 2):
        if b[3] and len(b) >= 8:
            size = _uint(b, 4, 4)
            return b[8:8 + size] if size else None
        return None
    flags = b[1]
    if flags & 0x20:
        size = _uint(b, 2, 4)
        return b[6:6 + size] if size else None
    return None


# ------------------------------------------------------------- chunk indices
def _chunks_v1btree(f: _File, addr: int, rank: int) -> List[Tuple[tuple, int, int, int]]:
    """(offsets, address, stored size, filter mask) of every chunk."""
    d, so = f.data, f.so
    ksize = 8 + 8 * (rank + 1)
    out = []
    stack = [addr]
    while stack:
        p = f.at(stack.pop())
        if d[p:p + 4] != b"TREE" or d[p + 4] != 1:
            raise ValueError(f"{f.name}: bad HDF5 chunk B-tree node")
        level, used = d[p + 5], _uint(d, p + 6, 2)
        q = p + 8 + 2 * so
        for i in range(used):
            k = q + i * (ksize + so)
            child = f.addr(k + ksize)
            if level:
                stack.append(child)
            else:
                offs = tuple(_uint(d, k + 8 + 8 * j, 8) for j in range(rank))
                out.append((offs, child, _uint(d, k, 4), _uint(d, k + 4, 4)))
    return out


def _ea_elements(f: _File, hdr_addr: int, filtered: bool, csize_len: int) -> Dict[int, tuple]:
    """Extensible-array index: {element index: (address, size, mask)}."""
    d, so = f.data, f.so
    p = f.at(hdr_addr)
    if d[p:p + 4] != b"EAHD":
        raise ValueError(f"{f.name}: bad HDF5 extensible array header")
    esize, max_bits, idx_n, dblk_min, sblk_min, page_bits = d[p + 6:p + 12]
    iblock = f.addr(p + 12 + 6 * f.sl)
    arr_off = (max_bits + 7) // 8

    def elem(q):
        a = f.addr(q)
        if filtered:
            return a, _uint(d, q + so, csize_len), _uint(d, q + so + csize_len, 4)
        return a, None, 0

    out = {}
    if iblock == UNDEF:
        return out
    q = f.at(iblock)
    if d[q:q + 4] != b"EAIB":
        raise ValueError(f"{f.name}: bad HDF5 extensible array index block")
    q += 6 + so
    for i in range(idx_n):
        out[i] = elem(q + i * esize)
    q += idx_n * esize
    nsblks = 1 + max_bits - (dblk_min.bit_length() - 1)
    info = []
    start = 0
    for s in range(nsblks):
        nd, ne = 1 << (s // 2), dblk_min << ((s + 1) // 2)
        info.append((nd, ne, start))
        start += nd * ne
    iblk_sblks = 2 * (sblk_min.bit_length() - 1)
    ndblk_addrs = 2 * (sblk_min - 1)
    dblk_addrs = [f.addr(q + i * so) for i in range(ndblk_addrs)]
    q += ndblk_addrs * so
    sblk_addrs = [f.addr(q + i * so) for i in range(nsblks - iblk_sblks)]

    def read_dblock(addr, ne, first):
        if addr == UNDEF:
            return
        if ne > (1 << page_bits):
            f.fail("paged extensible-array data block")
        r = f.at(addr)
        if d[r:r + 4] != b"EADB":
            raise ValueError(f"{f.name}: bad HDF5 extensible array data block")
        r += 6 + so + arr_off
        for i in range(ne):
            out[idx_n + first + i] = elem(r + i * esize)

    k = 0
    for s in range(iblk_sblks):
        nd, ne, st = info[s]
        for j in range(nd):
            read_dblock(dblk_addrs[k], ne, st + j * ne)
            k += 1
    for s in range(iblk_sblks, nsblks):
        a = sblk_addrs[s - iblk_sblks]
        if a == UNDEF:
            continue
        nd, ne, st = info[s]
        r = f.at(a)
        if d[r:r + 4] != b"EASB":
            raise ValueError(f"{f.name}: bad HDF5 extensible array secondary block")
        r += 6 + so + arr_off
        if ne > (1 << page_bits):
            f.fail("paged extensible-array data block")
        for j in range(nd):
            read_dblock(f.addr(r + j * so), ne, st + j * ne)
    return out


def _fa_elements(f: _File, hdr_addr: int, filtered: bool, csize_len: int) -> Dict[int, tuple]:
    d, so = f.data, f.so
    p = f.at(hdr_addr)
    if d[p:p + 4] != b"FAHD":
        raise ValueError(f"{f.name}: bad HDF5 fixed array header")
    esize, page_bits = d[p + 6], d[p + 7]
    n = _uint(d, p + 8, f.sl)
    dblk = f.addr(p + 8 + f.sl)
    out = {}
    if dblk == UNDEF:
        return out
    q = f.at(dblk)
    if d[q:q + 4] != b"FADB":
        raise ValueError(f"{f.name}: bad HDF5 fixed array data block")
    q += 6 + so

    def elem(r):
        a = f.addr(r)
        if filtered:
            return a, _uint(d, r + so, csize_len), _uint(d, r + so + csize_len, 4)
        return a, None, 0

    per_page = 1 << page_bits
    if n <= per_page:
        for i in range(n):
            out[i] = elem(q + i * esize)
        return out
    npages = -(-n // per_page)
    bitmap = d[q:q + (npages + 7) // 8]
    r = q + (npages + 7) // 8 + 4  # the bitmap, then the block's checksum
    for pg in range(npages):
        cnt = min(per_page, n - pg * per_page)
        if bitmap[pg // 8] & (0x80 >> (pg % 8)):
            for i in range(cnt):
                out[pg * per_page + i] = elem(r + i * esize)
        r += cnt * esize + 4
    return out


def _enc_size(n: int) -> int:
    """H5VM_limit_enc_size: bytes to store counts up to n."""
    return (n.bit_length() - 1) // 8 + 1


def _bt2_records(f: _File, hdr_addr: int, rank: int, csize_len: int):
    """(scaled offsets, address, stored size, mask) of every record of a v2
    B-tree chunk index (record types 10 and 11), internal nodes included."""
    d, so = f.data, f.so
    p = f.at(hdr_addr)
    if d[p:p + 4] != b"BTHD":
        raise ValueError(f"{f.name}: bad HDF5 v2 B-tree header")
    btype, node_size = d[p + 5], _uint(d, p + 6, 4)
    rsize, depth = _uint(d, p + 10, 2), _uint(d, p + 12, 2)
    root, nroot = f.addr(p + 16), _uint(d, p + 16 + so, 2)
    if btype not in (10, 11):
        f.fail(f"v2 B-tree of record type {btype}")
    # H5B2__hdr_init: each level's maximal records and its count fields' sizes
    max_nrec = [(node_size - 10) // rsize]
    cum = [max_nrec[0]]
    cum_size = [0]
    nrec_size = _enc_size(max_nrec[0])
    for u in range(1, depth + 1):
        ptr = so + nrec_size + cum_size[u - 1]
        max_nrec.append((node_size - (10 + ptr)) // (rsize + ptr))
        cum.append((max_nrec[u] + 1) * cum[u - 1] + max_nrec[u])
        cum_size.append(_enc_size(cum[u]))
    out = []

    def record(r):
        a = f.addr(r)
        r += so
        size, mask = None, 0
        if btype == 11:
            size, mask = _uint(d, r, csize_len), _uint(d, r + csize_len, 4)
            r += csize_len + 4
        out.append((tuple(_uint(d, r + 8 * j, 8) for j in range(rank)), a, size, mask))

    def node(addr, nrec, level):
        q = f.at(addr)
        if d[q:q + 4] != (b"BTIN" if level else b"BTLF"):
            raise ValueError(f"{f.name}: bad HDF5 v2 B-tree node")
        q += 6
        for i in range(nrec):
            record(q + i * rsize)
        if not level:
            return
        q += nrec * rsize
        step = so + nrec_size + (cum_size[level - 1] if level > 1 else 0)
        for i in range(nrec + 1):
            c = q + i * step
            node(f.addr(c), _uint(d, c + so, nrec_size), level - 1)

    if root != UNDEF:
        node(root, nroot, depth)
    return out


def _csize_len(chunk_bytes: int) -> int:
    """Bytes of a filtered chunk's size field in the v4 indices:
    1 + (floor(log2(chunk bytes)) + 8) / 8, at most 8."""
    return min(1 + (chunk_bytes.bit_length() - 1 + 8) // 8, 8)


# -------------------------------------------------------------------- reading
def read_dataset(src: Source, name: str) -> np.ndarray:
    """np.asarray(h5py.File(src)[name]) (see the module docstring)."""
    data, fname = read_source(src)
    f = _File(data, fname)
    addr = f.root
    for part in [p for p in name.split("/") if p]:
        addr = f.child(addr, part)
    shape = maxshape = dtype = layout = fill = None
    pipeline = []
    for mtype, b in f.messages(addr):
        if mtype == 0x01:
            version, rank, flags = b[0], b[1], b[2]
            p = 8 if version == 1 else 4
            if version == 2 and b[3] == 2:
                shape = None
                continue
            shape = tuple(_uint(b, p + 8 * i, 8) for i in range(rank))
            maxshape = (tuple(_uint(b, p + 8 * (rank + i), 8) for i in range(rank))
                        if flags & 1 else shape)
        elif mtype == 0x03:
            dtype = _dtype(f, b)
        elif mtype == 0x08:
            layout = b
        elif mtype == 0x0B:
            pipeline = _pipeline(f, b)
        elif mtype == 0x05:
            fill = _fill(b)
        elif mtype == 0x04 and fill is None:
            size = _uint(b, 0, 4)
            fill = b[4:4 + size] if size else None
        elif mtype == 0x07:
            f.fail("external storage")
    if layout is None or dtype is None:
        raise ValueError(f"{fname}: '{name}' is not an HDF5 dataset")
    if shape is None:
        f.fail("null dataspace")
    rank = len(shape)
    esize = dtype.itemsize
    n = int(np.prod(shape, dtype=np.int64))
    version, cls = layout[0], layout[1]
    if version < 3:
        f.fail(f"data layout message version {version}")
    if cls == 0:
        size = _uint(layout, 2, 2)
        return np.frombuffer(layout[4:4 + size], dtype, n).reshape(shape).copy()
    if cls == 1:
        a = f.addr_in(layout, 2)
        if a == UNDEF:
            return _filled(shape, dtype, fill)
        p = f.at(a)
        return np.frombuffer(data, dtype, n, p).reshape(shape).copy()
    if cls != 2:
        f.fail("virtual dataset layout" if cls == 3 else f"layout class {cls}")
    if version == 3:
        nd = layout[2]
        index = f.addr_in(layout, 3)
        cdims = tuple(_uint(layout, 3 + f.so + 4 * i, 4) for i in range(nd))[:rank]
        itype, iinfo = 0, None
    else:
        flags, nd, enc = layout[2], layout[3], layout[4]
        p = 5
        cdims = tuple(_uint(layout, p + enc * i, enc) for i in range(nd))[:rank]
        p += enc * nd
        itype = layout[p]
        p += 1
        iinfo = (flags, p)
        if itype == 1:
            if flags & 2:
                p += f.sl + 4
        elif itype == 3:
            p += 1
        elif itype == 4:
            p += 5
        elif itype == 5:
            p += 6
        index = f.addr_in(layout, p)
    out = _filled(shape, dtype, fill)
    if index == UNDEF:
        return out
    nchunks = [-(-s // c) for s, c in zip(shape, cdims)]
    maxchunks = [-(-m // c) if m != UNDEF else None for m, c in zip(maxshape, cdims)]
    chunk_bytes = int(np.prod(cdims)) * esize
    filtered = bool(pipeline)
    csl = _csize_len(chunk_bytes)
    chunks = []  # (scaled offsets, address, stored size, mask)
    if itype == 0:
        for offs, a, size, mask in _chunks_v1btree(f, index, rank):
            chunks.append((tuple(o // c for o, c in zip(offs, cdims)), a, size, mask))
    elif itype == 1:
        flags, p = iinfo
        size, mask = (_uint(layout, p, f.sl), _uint(layout, p + f.sl, 4)) if flags & 2 else (
            chunk_bytes, 0)
        chunks.append(((0,) * rank, index, size, mask))
    elif itype in (2, 3, 4):
        # the linear chunk index runs row-major over the maximal chunk counts;
        # an extensible array's unlimited axis goes first (H5VM_swizzle_coords)
        order = list(range(rank))
        if itype == 4:
            unlim = [i for i, m in enumerate(maxshape) if m == UNDEF]
            if len(unlim) != 1:
                f.fail("extensible-array chunk index without one unlimited axis")
            order = unlim + [i for i in order if i != unlim[0]]
        elif None in maxchunks:
            f.fail("unlimited axis under a fixed chunk index")
        if itype == 2:
            elems = None
        else:
            esz = f.data[f.at(index) + 6]
            read = _fa_elements if itype == 3 else _ea_elements
            elems = read(f, index, filtered, esz - f.so - 4 if filtered else 0)
        for scaled in np.ndindex(*nchunks):
            lin = scaled[order[0]]
            for i in order[1:]:
                lin = lin * maxchunks[i] + scaled[i]
            if elems is None:
                chunks.append((scaled, index + lin * chunk_bytes, chunk_bytes, 0))
            elif lin in elems:
                a, size, mask = elems[lin]
                if a != UNDEF:
                    chunks.append((scaled, a, size if size is not None else chunk_bytes, mask))
    elif itype == 5:
        for scaled, a, size, mask in _bt2_records(f, index, rank, csl):
            chunks.append((scaled, a, size if size is not None else chunk_bytes, mask))
    else:
        f.fail(f"chunk index type {itype}")
    for scaled, a, size, mask in chunks:
        p = f.at(a)
        raw = data[p:p + size]
        if filtered:
            raw = _unfilter(f, raw, pipeline, mask)
        if len(raw) < chunk_bytes:
            raise ValueError(f"{fname}: truncated HDF5 chunk")
        block = np.frombuffer(raw, dtype, chunk_bytes // esize).reshape(cdims)
        lo = [s * c for s, c in zip(scaled, cdims)]
        hi = [min(l + c, s) for l, c, s in zip(lo, cdims, shape)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        out[tuple(slice(l, h) for l, h in zip(lo, hi))] = block[
            tuple(slice(0, h - l) for l, h in zip(lo, hi))]
    return out


def _filled(shape, dtype, fill) -> np.ndarray:
    if fill is not None and len(fill) == dtype.itemsize:
        return np.full(shape, np.frombuffer(fill, dtype)[0], dtype)
    return np.zeros(shape, dtype)


# -------------------------------------------------------------------- writing
def _dtype_message(dtype: np.dtype) -> bytes:
    dtype = np.dtype(dtype)
    be = 1 if dtype.byteorder == ">" else 0
    size = dtype.itemsize
    if dtype.kind in "iu":
        bits = be | (8 if dtype.kind == "i" else 0)
        return bytes([0x10, bits, 0, 0]) + struct.pack("<IHH", size, 0, 8 * size)
    if dtype.kind == "f" and size in (2, 4, 8):
        mant, esz, bias = {2: (10, 5, 15), 4: (23, 8, 127), 8: (52, 11, 1023)}[size]
        return (bytes([0x11, be | 0x20, 8 * size - 1, 0]) + struct.pack("<IHH", size, 0, 8 * size)
                + bytes([mant, esz, 0, mant]) + struct.pack("<I", bias))
    raise ValueError(f"write_dataset: dtype {dtype} is not supported")


def _msg_v1(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body += bytes(-len(body) % 8)
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _objheader_v1(msgs: bytes, nmsgs: int) -> bytes:
    return struct.pack("<BxHII4x", 1, nmsgs, 1, len(msgs)) + msgs


def write_dataset(path, name: str, array: np.ndarray) -> None:
    """Write `array` as dataset `name` (in the root group) of a new HDF5 file
    in the default file format, chunked along axis 0 into at most 64 chunks
    of about CHUNK_BYTES, each deflated at GZIP_LEVEL."""
    arr = np.ascontiguousarray(array)
    if arr.ndim == 0 or arr.size == 0:
        raise ValueError("write_dataset takes a non-empty array of one dimension or more")
    dtm = _dtype_message(arr.dtype)
    shape = arr.shape
    rank = arr.ndim
    row_bytes = arr.nbytes // shape[0]
    rows = max(1, min(shape[0], CHUNK_BYTES // max(1, row_bytes)))
    rows = max(rows, -(-shape[0] // 64))
    cdims = (rows,) + shape[1:]
    nch = -(-shape[0] // rows)
    K_IST, K_SYM_LEAF, K_SYM_INT = 32, 4, 16
    so = 8
    pos = 96  # after the superblock
    # root group: object header, local heap (header + data), group B-tree, SNOD
    root_oh_at = pos
    root_oh = _objheader_v1(_msg_v1(0x11, bytes(16)), 1)
    pos += len(root_oh)
    heap_at = pos
    heap_data = b"\x00" * 8 + name.encode() + b"\x00"
    heap_data += bytes(-len(heap_data) % 8)
    heap_data_at = heap_at + 32
    pos = heap_data_at + len(heap_data)
    gtree_at = pos
    gtree_size = 24 + (2 * K_SYM_INT + 1) * 8 + 2 * K_SYM_INT * so
    pos += gtree_size
    snod_at = pos
    snod_size = 8 + 2 * K_SYM_LEAF * (2 * so + 24)
    pos += snod_size
    # the dataset's object header
    dset_at = pos
    space = struct.pack("<BBB5x", 1, rank, 0) + b"".join(struct.pack("<Q", s) for s in shape)
    fillv = bytes([2, 3, 2, 0])
    layout_len = 3 + so + 4 * (rank + 1)
    pipe = bytes([1, 1]) + bytes(6) + struct.pack("<HHHH", 1, 0, 1, 1) + struct.pack(
        "<I", GZIP_LEVEL) + bytes(4)
    msgs_wo_layout = _msg_v1(0x01, space) + _msg_v1(0x03, dtm, 1) + _msg_v1(0x05, fillv, 1)
    layout_placeholder = _msg_v1(0x08, bytes(layout_len))
    dset_oh_len = 16 + len(msgs_wo_layout) + len(layout_placeholder) + len(_msg_v1(0x0B, pipe))
    pos += dset_oh_len
    ctree_at = pos
    ksize = 8 + 8 * (rank + 1)
    ctree_size = 24 + (2 * K_IST + 1) * ksize + 2 * K_IST * so
    pos += ctree_size
    blobs = []
    for i in range(nch):
        raw = arr[i * rows:(i + 1) * rows].tobytes()  # the last chunk padded with zeros
        raw += bytes(rows * row_bytes - len(raw))
        blobs.append((pos, zlib.compress(raw, GZIP_LEVEL)))
        pos += len(blobs[-1][1])
    eof = pos

    out = bytearray(eof)
    sb = SIGNATURE + bytes([0, 0, 0, 0, 0, so, 8, 0]) + struct.pack(
        "<HHI", K_SYM_LEAF, K_SYM_INT, 0) + struct.pack("<QQQQ", 0, UNDEF, eof, UNDEF)
    sb += struct.pack("<QQII", 0, root_oh_at, 1, 0) + struct.pack("<QQ", gtree_at, heap_at)
    out[0:len(sb)] = sb
    root_oh = _objheader_v1(_msg_v1(0x11, struct.pack("<QQ", gtree_at, heap_at)), 1)
    out[root_oh_at:root_oh_at + len(root_oh)] = root_oh
    heap = b"HEAP" + bytes([0, 0, 0, 0]) + struct.pack("<QQQ", len(heap_data), 1, heap_data_at)
    out[heap_at:heap_at + 32] = heap
    out[heap_data_at:heap_data_at + len(heap_data)] = heap_data
    gtree = b"TREE" + bytes([0, 0]) + struct.pack("<HQQ", 1, UNDEF, UNDEF) + struct.pack(
        "<QQQ", 0, snod_at, 8)
    out[gtree_at:gtree_at + len(gtree)] = gtree
    snod = b"SNOD" + bytes([1, 0]) + struct.pack("<H", 1) + struct.pack("<QQII", 8, dset_at, 0, 0)
    out[snod_at:snod_at + len(snod)] = snod
    layout = bytes([3, 2, rank + 1]) + struct.pack("<Q", ctree_at) + b"".join(
        struct.pack("<I", c) for c in cdims) + struct.pack("<I", arr.dtype.itemsize)
    msgs = msgs_wo_layout + _msg_v1(0x08, layout) + _msg_v1(0x0B, pipe, 1)
    oh = _objheader_v1(msgs, 5)
    assert len(oh) == dset_oh_len
    out[dset_at:dset_at + len(oh)] = oh
    ct = b"TREE" + bytes([1, 0]) + struct.pack("<HQQ", nch, UNDEF, UNDEF)
    for i, (a, blob) in enumerate(blobs):
        ct += struct.pack("<II", len(blob), 0) + struct.pack("<Q", i * rows) + bytes(8 * rank)
        ct += struct.pack("<Q", a)
    ct += struct.pack("<II", 0, 0) + struct.pack("<Q", nch * rows) + bytes(8 * rank)
    out[ctree_at:ctree_at + len(ct)] = ct
    for a, blob in blobs:
        out[a:a + len(blob)] = blob
    with open(path, "wb") as fh:
        fh.write(bytes(out))

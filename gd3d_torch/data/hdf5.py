"""HDF5 reading and writing without h5py, to h5py's arrays.

gd3d reads MegaDepth's depth maps and the HDF5 stereo / flow ground truth
(`.h5`, `.hdf5`, `.flo5`) with h5py and writes `.flo5` flows with it
(gd3d/data/preprocess_mvs.py, gd3d/data/flowio.py); the card's machine has
no h5py. `read_dataset(path, name)` gives h5py.File(path)[name][()]
for one dataset as h5py 3.14 (HDF5 1.14) writes it, at its default file
format and with libver="latest":

  * superblocks v0-v3 with offsets and lengths of 2, 4 or 8 bytes; object
    headers v1 and v2 (with their continuation blocks); groups as symbol
    tables (v1 B-tree, SNOD nodes, local heap), compact link messages or
    dense link storage (fractal heap, v2 B-tree name index), walked along
    the dataset's path through hard, soft and external links (an external
    file is looked for as HDF5 looks: the path as given where it is
    absolute and exists, then beside the referring file, then from the
    working directory);
  * types: IEEE float16/32/64 and 8-64-bit integers in either byte order
    (returned in the stored byte order, as h5py returns them; an integer
    whose precision is below its size is read from its bit field and
    sign-extended), fixed-length strings (`S`, with HDF5's null-terminated,
    null-padded and space-padded rules), compound types (nested too) as
    structured arrays at the file's member offsets, enums as their base
    integers, array types as trailing axes, and variable-length strings
    (bytes) and sequences (arrays) as object arrays, read through the
    global heap;
  * compact, contiguous, external (`external=[...]`, its files found from
    the working directory, as HDF5 finds them) and chunked layouts (layout
    messages v3 and v4), chunks found through the v1 B-tree or the v4
    indices: single chunk, implicit, fixed array (paged or not),
    extensible array and v2 B-tree;
  * the deflate, shuffle, fletcher32 (checked), lzf, szip (CCSDS 121.0
    adaptive entropy decoding as libaec's szip interface writes it), n-bit
    and scale-offset (integer, and float D-scaling) filters, a chunk's
    filter mask honoured, and the fill value where a chunk was never
    written.

Anything else raises ValueError naming the file and the feature: virtual
datasets, object and region references, time, bitfield and opaque types,
variable-length members of a compound, and the rarer filter settings.

`write_dataset(path, name, array)` writes one dataset in the default file
format (superblock v0, v1 object headers, a symbol-table root group), chunked
along its first axis with the deflate filter at level 5 (gd3d's write_flo5
asks h5py for that level), which h5py reads back equal. Metadata
checksums of the v2 structures are not verified.
"""
from __future__ import annotations

import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from gd3d_torch.data.source import Source, read_source


SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
GZIP_LEVEL = 5  # gd3d's write_flo5 has h5py deflate at level 5
CHUNK_BYTES = 1 << 20  # write_dataset's chunk target
MAX_LINK_HOPS = 16  # soft and external links followed on one path, as HDF5's H5L_NUM_LINKS
_FILTERS = {1: "deflate", 2: "shuffle", 3: "fletcher32", 4: "szip", 5: "nbit",
            6: "scaleoffset", 32000: "lzf"}
_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 7: "reference"}


def _uint(b: bytes, off: int, n: int) -> int:
    return int.from_bytes(b[off:off + n], "little")


class _File:
    def __init__(self, data: bytes, name: str, path: Optional[str] = None):
        self.data, self.name, self.path = data, name, path
        self._gheap: Dict[int, Dict[int, bytes]] = {}
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
        if self.so not in (2, 4, 8) or self.sl not in (2, 4, 8):
            self.fail(f"offset size {self.so} / length size {self.sl}")

    def addr(self, pos: int) -> int:
        """The address at `pos`, UNDEF where it is undefined (all ones)."""
        a = _uint(self.data, pos, self.so)
        return UNDEF if a == (1 << 8 * self.so) - 1 else a

    def length(self, pos: int) -> int:
        return _uint(self.data, pos, self.sl)

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
        a = _uint(b, off, self.so)
        return UNDEF if a == (1 << 8 * self.so) - 1 else a

    # ------------------------------------------------------------------ groups
    def link(self, header: int, name: str):
        """Link `name` of the group at header: ("hard", address), ("soft",
        path) or ("external", (file, path))."""
        msgs = self.messages(header)
        for mtype, body in msgs:
            if mtype == 0x11:  # symbol table
                return self._symbol_table_lookup(self.addr_in(body, 0),
                                                 self.addr_in(body, self.so), name)
        for mtype, body in msgs:
            if mtype == 0x02:  # link info: dense storage where the heap exists
                p = 2 + (8 if body[1] & 1 else 0)
                heap, btree = self.addr_in(body, p), self.addr_in(body, p + self.so)
                if heap != UNDEF:
                    return self._dense_lookup(heap, btree, name)
        for mtype, body in msgs:
            if mtype == 0x06:
                link = self._link(body)
                if link[0] == name:
                    return link[1:]
        raise ValueError(f"{self.name}: no object '{name}' in the HDF5 file")

    def _link(self, b: bytes):
        """(name, kind, target) of a link message."""
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
        if ltype == 0:
            return lname, "hard", self.addr_in(b, p)
        size = _uint(b, p, 2)
        value = b[p + 2:p + 2 + size]
        if ltype == 1:
            return lname, "soft", value.decode("utf-8", "replace")
        if ltype == 64:
            file_name, _, rest = value[1:].partition(b"\x00")
            return lname, "external", (file_name.decode("utf-8", "replace"),
                                       rest.partition(b"\x00")[0].decode("utf-8", "replace"))
        self.fail(f"link type {ltype} ('{lname}')")

    def _heap_string(self, heap: int, off: int) -> str:
        d = self.data
        hp = self.at(heap)
        if d[hp:hp + 4] != b"HEAP":
            raise ValueError(f"{self.name}: bad HDF5 local heap")
        seg = self.at(self.addr(hp + 8 + 2 * self.sl))
        end = d.index(b"\x00", seg + off)
        return d[seg + off:end].decode("utf-8", "replace")

    def _symbol_table_lookup(self, btree: int, heap: int, name: str):
        d = self.data
        so = self.so
        stack = [btree]
        while stack:
            p = self.at(stack.pop())
            if d[p:p + 4] == b"TREE":
                used = _uint(d, p + 6, 2)
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
                    if _uint(d, e + 2 * so, 4) == 2:  # a soft link: its value in the heap
                        return "soft", self._heap_string(heap, _uint(d, e + 2 * so + 8, 4))
                    return "hard", self.addr(e + so)
        raise ValueError(f"{self.name}: no object '{name}' in the HDF5 file")

    def _dense_lookup(self, heap: int, btree: int, name: str):
        """A link of a group in dense storage: every record of its name index
        (a v2 B-tree of type 5: name hash, heap ID) read from the fractal
        heap until the name matches."""
        heap_obj = _FractalHeap(self, heap)
        btype, records = _bt2_walk(self, btree)
        if btype != 5:
            self.fail(f"link name index of v2 B-tree record type {btype}")
        for r in records:
            body = heap_obj.get(self.data[r + 4:r + 4 + heap_obj.id_len])
            link = self._link(body)
            if link[0] == name:
                return link[1:]
        raise ValueError(f"{self.name}: no object '{name}' in the HDF5 file")

    # ------------------------------------------------------------ global heap
    def global_heap_object(self, collection: int, index: int) -> bytes:
        objs = self._gheap.get(collection)
        if objs is None:
            d, sl = self.data, self.sl
            p = self.at(collection)
            if d[p:p + 4] != b"GCOL":
                raise ValueError(f"{self.name}: bad HDF5 global heap collection")
            end = p + self.length(p + 8)
            q = p + 8 + sl
            objs = {}
            while q + 8 + sl <= end:
                idx, size = _uint(d, q, 2), self.length(q + 8)
                if idx == 0:  # the free space runs to the end
                    break
                objs[idx] = d[q + 8 + sl:q + 8 + sl + size]
                q += 8 + sl + size + (-size % 8)
            self._gheap[collection] = objs
        if index not in objs:
            raise ValueError(f"{self.name}: no HDF5 global heap object {index} at {collection:#x}")
        return objs[index]


class _FractalHeap:
    """Managed and tiny objects of a fractal heap (the links of a group in
    dense storage): a root direct block, or a root indirect block over
    direct blocks."""

    def __init__(self, f: _File, addr: int):
        d, so, sl = f.data, f.so, f.sl
        p = f.at(addr)
        if d[p:p + 4] != b"FRHP":
            raise ValueError(f"{f.name}: bad HDF5 fractal heap header")
        self.f = f
        self.id_len, filt_len, self.flags = _uint(d, p + 5, 2), _uint(d, p + 7, 2), d[p + 9]
        max_man = _uint(d, p + 10, 4)
        q = p + 14 + sl + so + sl + so + 8 * sl
        self.width, self.start = _uint(d, q, 2), f.length(q + 2)
        max_direct, max_heap_bits = f.length(q + 2 + sl), _uint(d, q + 2 + 2 * sl, 2)
        q += 4 + 2 * sl + 2
        self.root = f.addr(q)
        self.root_rows = _uint(d, q + so, 2)
        if filt_len:
            f.fail("filtered fractal heap")
        self.off_size = (max_heap_bits + 7) // 8
        self.len_size = min(((max_direct.bit_length() - 1) + 7) // 8, _enc_size(max_man))
        self.max_direct_rows = (max_direct.bit_length() - 1) - (self.start.bit_length() - 1) + 2
        self.blocks = []  # (heap offset, block address, block size)
        if self.root == UNDEF:
            return
        if self.root_rows == 0:
            self.blocks.append((0, self.root, self.start))
            return
        r = f.at(self.root)
        if d[r:r + 4] != b"FHIB":
            raise ValueError(f"{f.name}: bad HDF5 fractal heap indirect block")
        r += 5 + so + self.off_size
        offset = 0
        for row in range(self.root_rows):
            size = self.start if row == 0 else self.start << (row - 1)
            for _ in range(self.width):
                if row >= self.max_direct_rows:
                    if f.addr(r) != UNDEF:
                        f.fail("fractal heap with nested indirect blocks")
                elif f.addr(r) != UNDEF:
                    self.blocks.append((offset, f.addr(r), size))
                r += so
                offset += size

    def get(self, heap_id: bytes) -> bytes:
        kind = (heap_id[0] >> 4) & 3
        if kind == 2:  # tiny: the object is in the ID
            return heap_id[1:1 + (heap_id[0] & 0x0F) + 1]
        if kind != 0:
            self.f.fail("huge fractal heap object")
        off = _uint(heap_id, 1, self.off_size)
        size = _uint(heap_id, 1 + self.off_size, self.len_size)
        for start, addr, bsize in self.blocks:
            if start <= off < start + bsize:
                p = self.f.at(addr)
                if self.f.data[p:p + 4] != b"FHDB":
                    raise ValueError(f"{self.f.name}: bad HDF5 fractal heap direct block")
                return self.f.data[p + off - start:p + off - start + size]
        raise ValueError(f"{self.f.name}: HDF5 fractal heap offset {off} in no block")


# ------------------------------------------------------------------ datatype
class _Type:
    """A file datatype as h5py reads it: `dtype` (h5py's numpy dtype, object
    for variable-length types) and `read(f, raw, n)`, the n elements of raw
    bytes as h5py's array."""

    def __init__(self, dtype, size, kind="plain", **info):
        self.dtype, self.size, self.kind, self.info = np.dtype(dtype), size, kind, info

    @property
    def fixed(self) -> bool:
        """Whether the elements' bytes are the array's (no conversion)."""
        return self.kind == "plain"

    def read(self, f: _File, raw: bytes, n: int) -> np.ndarray:
        if self.kind == "vlen":
            return self._read_vlen(f, raw, n)
        if self.kind == "array":
            base = self.info["base"]
            count = int(np.prod(self.info["dims"]))
            return base.read(f, raw, n * count).reshape((n,) + self.info["dims"])
        arr = np.frombuffer(raw, self.dtype, n).copy()
        self.convert(arr)
        return arr

    def convert(self, arr: np.ndarray) -> None:
        """In place: the bit field of an integer narrower than its size, a
        fixed string's padding, a compound's members."""
        if self.kind == "bits":
            offset, precision, signed = self.info["bits"]
            u = arr.view(arr.dtype.str.replace("i", "u")).astype(np.uint64)
            u = (u >> np.uint64(offset)) & np.uint64((1 << precision) - 1)
            v = u.astype(np.int64)
            if signed:
                v = np.where(v >= 1 << (precision - 1), v - (1 << precision), v)
            arr[...] = v.astype(arr.dtype)
        elif self.kind == "string":
            pad = self.info["pad"]
            flat = arr.reshape(-1)
            for i, s in enumerate(flat.tolist()):
                raw = bytes(s)
                if pad == 0:
                    raw = raw.split(b"\x00", 1)[0]
                elif pad == 2:
                    raw = raw.rstrip(b" ")
                flat[i] = raw
        elif self.kind == "compound":
            for name, member in self.info["members"]:
                if not member.fixed:
                    member.convert(arr[name])

    def _read_vlen(self, f: _File, raw: bytes, n: int) -> np.ndarray:
        out = np.empty(n, object)
        base, string = self.info["base"], self.info["string"]
        step = 8 + f.so
        for i in range(n):
            count = _uint(raw, i * step, 4)
            coll = f.addr_in(raw, i * step + 4)
            index = _uint(raw, i * step + 4 + f.so, 4)
            body = b"" if coll in (0, UNDEF) or count == 0 else f.global_heap_object(coll, index)
            if string:
                out[i] = body[:count].split(b"\x00", 1)[0]
            else:
                out[i] = base.read(f, body[:count * base.size], count)
        return out


def _parse_type(f: _File, b: bytes, p: int = 0) -> Tuple[_Type, int]:
    """The datatype message at b[p:]: (the type, the position after it)."""
    cls, version = b[p] & 15, b[p] >> 4
    bits = _uint(b, p + 1, 3)
    size = _uint(b, p + 4, 4)
    q = p + 8
    order = ">" if bits & 1 else "<"
    if cls == 0:
        offset, precision = _uint(b, q, 2), _uint(b, q + 2, 2)
        if size not in (1, 2, 4, 8):
            f.fail(f"integer type of {size} bytes")
        signed = bool(bits & 8)
        dt = np.dtype(f"{order}{'i' if signed else 'u'}{size}")
        if offset == 0 and precision == 8 * size:
            return _Type(dt, size), q + 4
        return _Type(dt, size, "bits", bits=(offset, precision, signed)), q + 4
    if cls == 1:
        ieee = {2: (10, 5, 10, 15), 4: (23, 8, 23, 127), 8: (52, 11, 52, 1023)}.get(size)
        if bits & 0x40 or ieee is None:
            f.fail(f"floating-point type of {size} bytes")
        eloc, esize, msize, bias = b[q + 4], b[q + 5], b[q + 7], _uint(b, q + 8, 4)
        if (eloc, esize, msize, bias) != ieee or _uint(b, q, 2) or _uint(b, q + 2, 2) != 8 * size:
            f.fail(f"non-IEEE floating-point type of {size} bytes")
        return _Type(f"{order}f{size}", size), q + 12
    if cls == 3:
        return _Type(f"S{size}", size, "string", pad=bits & 15), q
    if cls == 6:
        nmembers = bits & 0xFFFF
        names, formats, offsets, members = [], [], [], []
        for _ in range(nmembers):
            end = b.index(b"\x00", q)
            mname = b[q:end].decode("utf-8", "replace")
            if version < 3:
                q += (end - q) // 8 * 8 + 8
                moff = _uint(b, q, 4)
                q += 4
                if version == 1:
                    ndims = b[q]
                    dims = tuple(_uint(b, q + 12 + 4 * i, 4) for i in range(ndims))
                    q += 28
                    if ndims:
                        f.fail(f"compound member '{mname}' with version-1 array dimensions")
            else:
                q = end + 1
                nb = max(1, (size.bit_length() + 7) // 8)
                moff = _uint(b, q, nb)
                q += nb
            mtype, q = _parse_type(f, b, q)
            if mtype.kind == "vlen":
                f.fail(f"variable-length compound member '{mname}'")
            names.append(mname)
            formats.append(mtype.dtype if mtype.kind != "array" else
                           np.dtype((mtype.info["base"].dtype, mtype.info["dims"])))
            offsets.append(moff)
            members.append((mname, mtype))
        dt = np.dtype({"names": names, "formats": formats, "offsets": offsets,
                       "itemsize": size})
        fixed = all(m.fixed or (m.kind == "array" and m.info["base"].fixed) for _, m in members)
        return _Type(dt, size, "plain" if fixed else "compound", members=members), q
    if cls == 8:
        base, q = _parse_type(f, b, q)
        nmembers = bits & 0xFFFF
        for _ in range(nmembers):
            end = b.index(b"\x00", q)
            q = end + 1 if version >= 3 else q + (end - q) // 8 * 8 + 8
        q += nmembers * base.size
        return base, q
    if cls == 9:
        base, q = _parse_type(f, b, q)
        string = (bits & 15) == 1
        return _Type(object, 8 + f.so, "vlen", base=base, string=string), q
    if cls == 10:
        ndims = b[q]
        q += 1 if version >= 3 else 4
        dims = tuple(_uint(b, q + 4 * i, 4) for i in range(ndims))
        q += 4 * ndims + (4 * ndims if version < 3 else 0)
        base, q = _parse_type(f, b, q)
        if base.kind == "vlen":
            f.fail("array of variable-length type")
        return _Type((base.dtype, dims), size, "array", base=base, dims=dims), q
    f.fail(f"{_CLASSES.get(cls, f'class {cls}')} datatype")


# ------------------------------------------------------------------- filters
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


def _lzf(f: _File, src: bytes, out_len: int) -> bytes:
    """liblzf's lzf_decompress (h5py's filter 32000)."""
    out = bytearray()
    i, n = 0, len(src)
    while i < n:
        ctrl = src[i]
        i += 1
        if ctrl < 32:
            out += src[i:i + ctrl + 1]
            i += ctrl + 1
            continue
        length = ctrl >> 5
        if length == 7:
            length += src[i]
            i += 1
        ref = len(out) - ((ctrl & 0x1F) << 8) - src[i] - 1
        i += 1
        if ref < 0:
            raise ValueError(f"{f.name}: corrupt HDF5 lzf chunk")
        for k in range(length + 2):
            out.append(out[ref + k])
    if len(out) != out_len:
        raise ValueError(f"{f.name}: HDF5 lzf chunk of {len(out)} bytes, not {out_len}")
    return bytes(out)


def _bits_msb(buf: bytes, nbits: int, count: int, start_bit: int = 0) -> np.ndarray:
    """`count` unsigned values of `nbits` bits each, read MSB first from a
    big-endian bit stream starting at bit `start_bit`."""
    bits = np.unpackbits(np.frombuffer(buf, np.uint8))[start_bit:start_bit + nbits * count]
    if len(bits) < nbits * count:
        raise ValueError("truncated bit stream")
    bits = bits.reshape(count, nbits).astype(np.uint64)
    weights = np.left_shift(np.uint64(1), np.arange(nbits - 1, -1, -1, dtype=np.uint64))
    return (bits * weights).sum(axis=1, dtype=np.uint64)


def _nbit(f: _File, raw: bytes, cd: List[int]) -> bytes:
    """H5Z's n-bit filter (atomic integer and float types): each element's
    `precision` significant bits, packed MSB first, shifted back to
    `offset`; the other bits zero."""
    if cd[1]:  # need_not_compress: stored as it is
        return raw
    nelmts, cls = cd[2], cd[3]
    if cls not in (1, 2):
        f.fail("n-bit filter on a compound or no-op type")
    size, order, precision, offset = cd[4], cd[5], cd[6], cd[7]
    vals = _bits_msb(raw, precision, nelmts) << np.uint64(offset)
    return vals.astype(f"{'>' if order else '<'}u{size}").tobytes()


def _scaleoffset(f: _File, raw: bytes, cd: List[int]) -> bytes:
    """H5Z's scale-offset filter: integers (min + value, the all-ones code the
    fill value) and floats by D-scaling (value / 10^D + min, in the
    element's precision)."""
    scale_type, scale, nelmts, cls, size, sign, order, filavail = cd[:8]
    if cls == 1 and scale_type != 0:
        f.fail("scale-offset filter with float E-scaling")
    minbits = _uint(raw, 0, 4)
    minval = _uint(raw, 5, min(8, raw[4]))
    stored = ">" if order else "<"
    body = raw[21:]
    if minbits == 8 * size:
        return body[:nelmts * size]
    if minbits == 0:
        vals = np.zeros(nelmts, np.uint64)
    else:
        vals = _bits_msb(body, minbits, nelmts)
    full = np.uint64((1 << minbits) - 1) if minbits < 64 else np.uint64(UNDEF)
    fill = None
    if filavail:
        fill_bytes = b"".join(int(v).to_bytes(4, "little") for v in cd[8:8 + (size + 3) // 4])
        fill = np.frombuffer(fill_bytes[:size], f"<{'f' if cls == 1 else ('i' if sign else 'u')}{size}")[0]
    if cls == 0:
        it = np.dtype(f"<{'i' if sign else 'u'}{size}")
        wrap = np.uint64((1 << 8 * size) - 1) if size < 8 else np.uint64(UNDEF)
        out = ((vals + np.uint64(minval)) & wrap).astype(f"<u{size}").view(it).copy()
        if fill is not None:
            out[vals == full] = fill
        return out.astype(it.newbyteorder(stored)).tobytes()
    ft = np.dtype(f"<f{size}")
    it = np.dtype(f"<i{size}")
    mn = np.frombuffer(minval.to_bytes(8, "little")[:size], ft)[0]
    ints = vals.astype(f"<u{size}").view(it)
    out = (ints.astype(ft) / ft.type(10.0 ** scale) + mn).astype(ft)
    if fill is not None:
        out[vals == full] = fill
    return out.astype(ft.newbyteorder(stored)).tobytes()


def _szip(f: _File, raw: bytes, cd: List[int]) -> bytes:
    """HDF5's szip filter as libaec's szip interface writes it: the
    uncompressed size (4 bytes), then a CCSDS 121.0 adaptive entropy coded
    stream of bits_per_pixel-bit samples (32- and 64-bit pixels as their
    bytes, interleaved plane by plane) in blocks of pixels_per_block,
    pixels_per_scanline / pixels_per_block blocks a reference sample
    interval, with the nearest-neighbour predictor under the NN option."""
    mask, ppb, bpp, pps = cd[:4]
    out_len = _uint(raw, 0, 4)
    interleave = bpp in (32, 64)
    n = 8 if interleave else bpp
    if n > 32:
        f.fail(f"szip filter on {bpp}-bit pixels")
    nbytes = (n + 7) // 8 if n > 8 else 1
    nbytes = {1: 1, 2: 2, 3: 4, 4: 4}.get(nbytes, nbytes)
    samples = -(-out_len // nbytes)
    preprocess, msb = bool(mask & 32), bool(mask & 16)
    rsi = -(-pps // ppb)
    values = _aec_decode(f, raw[4:], n, ppb, rsi, preprocess, samples)
    if n <= 8:
        data = values.astype(np.uint8).tobytes()
    else:
        data = values.astype(f"{'>' if msb else '<'}u{nbytes}").tobytes()
    data = data[:out_len]
    if interleave:
        w = bpp // 8
        data = np.frombuffer(data, np.uint8).reshape(w, -1).T.tobytes()
    return data


def _aec_decode(f: _File, buf: bytes, n: int, J: int, rsi: int, preprocess: bool,
                count: int) -> np.ndarray:
    """CCSDS 121.0 (libaec) decoding of at least `count` n-bit samples."""
    bits = np.unpackbits(np.frombuffer(buf, np.uint8))
    nb = len(bits)
    pos = 0
    id_len = 5 if n > 16 else (4 if n > 8 else 3)
    xmax = (1 << n) - 1
    out: List[int] = []

    def take(k):
        nonlocal pos
        if pos + k > nb:
            raise ValueError(f"{f.name}: truncated HDF5 szip chunk")
        v = 0
        for b in bits[pos:pos + k]:
            v = (v << 1) | int(b)
        pos += k
        return v

    def fs():
        nonlocal pos
        start = pos
        while pos < nb and not bits[pos]:
            pos += 1
        if pos >= nb:
            raise ValueError(f"{f.name}: truncated HDF5 szip chunk")
        pos += 1
        return pos - 1 - start

    while len(out) < count:
        vals: List[int] = []
        block = 0
        while block < rsi:
            ref = preprocess and block == 0
            ident = take(id_len)
            if ident == 0:
                second = take(1)
                if ref:
                    vals.append(take(n))
                if second:  # second extension: pairs
                    i = 1 if ref else 0
                    while i < J:
                        m = fs()
                        beta = int((np.sqrt(8 * m + 1) - 1) // 2)
                        while beta * (beta + 1) // 2 > m:
                            beta -= 1
                        while (beta + 1) * (beta + 2) // 2 <= m:
                            beta += 1
                        d1 = m - beta * (beta + 1) // 2
                        if i % 2 == 0:
                            vals.append(beta - d1)
                            i += 1
                        vals.append(d1)
                        i += 1
                    block += 1
                else:  # zero blocks
                    z = fs() + 1
                    if z == 5:  # to the end of the segment of 64 blocks or of the RSI
                        z = min(rsi - block, 64 - block % 64)
                    elif z > 5:
                        z -= 1
                    vals.extend([0] * (z * J - (1 if ref else 0)))
                    block += z
            elif ident == (1 << id_len) - 1:  # uncompressed
                vals.extend(take(n) for _ in range(J))
                block += 1
            else:  # split samples, k low bits
                k = ident - 1
                if ref:
                    vals.append(take(n))
                m = J - (1 if ref else 0)
                hi = [fs() for _ in range(m)]
                vals.extend((h << k) | take(k) if k else h for h in hi)
                block += 1
        if preprocess:
            x = vals[0]
            rec = [x]
            for d in vals[1:]:
                theta = min(x, xmax - x)
                if d <= 2 * theta:
                    x = x + d // 2 if d % 2 == 0 else x - (d + 1) // 2
                elif theta == x:
                    x = d
                else:
                    x = xmax - d
                rec.append(x)
            vals = rec
        out.extend(vals)
    return np.asarray(out[:count], np.uint64)


def _unfilter(f: _File, raw: bytes, pipeline, mask: int, chunk_bytes: int) -> bytes:
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
        elif fid == 32000:
            raw = _lzf(f, raw, chunk_bytes)
        elif fid == 4:
            raw = _szip(f, raw, cdata)
        elif fid == 5:
            raw = _nbit(f, raw, cdata)
        elif fid == 6:
            raw = _scaleoffset(f, raw, cdata)
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
        if fid not in _FILTERS:
            f.fail(f"filter {fid}")
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


def _bt2_walk(f: _File, hdr_addr: int):
    """(record type, position of every record) of a v2 B-tree, internal
    nodes' records included."""
    d, so = f.data, f.so
    p = f.at(hdr_addr)
    if d[p:p + 4] != b"BTHD":
        raise ValueError(f"{f.name}: bad HDF5 v2 B-tree header")
    btype, node_size = d[p + 5], _uint(d, p + 6, 4)
    rsize, depth = _uint(d, p + 10, 2), _uint(d, p + 12, 2)
    root, nroot = f.addr(p + 16), _uint(d, p + 16 + so, 2)
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

    def node(addr, nrec, level):
        q = f.at(addr)
        if d[q:q + 4] != (b"BTIN" if level else b"BTLF"):
            raise ValueError(f"{f.name}: bad HDF5 v2 B-tree node")
        q += 6
        out.extend(q + i * rsize for i in range(nrec))
        if not level:
            return
        q += nrec * rsize
        step = so + nrec_size + (cum_size[level - 1] if level > 1 else 0)
        for i in range(nrec + 1):
            c = q + i * step
            node(f.addr(c), _uint(d, c + so, nrec_size), level - 1)

    if root != UNDEF:
        node(root, nroot, depth)
    return btype, out


def _bt2_records(f: _File, hdr_addr: int, rank: int, csize_len: int):
    """(scaled offsets, address, stored size, mask) of every record of a v2
    B-tree chunk index (record types 10 and 11)."""
    d, so = f.data, f.so
    btype, positions = _bt2_walk(f, hdr_addr)
    if btype not in (10, 11):
        f.fail(f"v2 B-tree of record type {btype}")
    out = []
    for r in positions:
        a = f.addr(r)
        r += so
        size, mask = None, 0
        if btype == 11:
            size, mask = _uint(d, r, csize_len), _uint(d, r + csize_len, 4)
            r += csize_len + 4
        out.append((tuple(_uint(d, r + 8 * j, 8) for j in range(rank)), a, size, mask))
    return out


def _csize_len(chunk_bytes: int) -> int:
    """Bytes of a filtered chunk's size field in the v4 indices:
    1 + (floor(log2(chunk bytes)) + 8) / 8, at most 8."""
    return min(1 + (chunk_bytes.bit_length() - 1 + 8) // 8, 8)


# -------------------------------------------------------------------- reading
def _open_external(f: _File, file_name: str) -> _File:
    """The file an external link names, looked for as HDF5 looks
    (H5F_prefix_open_file, no prefix set): the name as given where it is
    absolute, then its name beside the referring file, then from the
    working directory."""
    tries = []
    if os.path.isabs(file_name):
        tries.append(file_name)
        file_name = os.path.basename(file_name)
    if f.path is not None:
        tries.append(os.path.join(os.path.dirname(os.path.abspath(f.path)), file_name))
    tries.append(file_name)
    for p in tries:
        if os.path.isfile(p):
            data, name = read_source(p)
            return _File(data, name, p)
    raise ValueError(f"{f.name}: the HDF5 external link's file '{file_name}' was not found "
                     f"(looked at {tries})")


def _walk(f: _File, group: int, path: str, hops: int = 0) -> Tuple[_File, int]:
    """(file, object header address) of `path` from the group at `group`
    (from the root where the path is absolute), links followed."""
    if path.startswith("/"):
        group = f.root
    for part in [p for p in path.split("/") if p and p != "."]:
        kind, target = f.link(group, part)
        if kind == "hard":
            group = target
            continue
        hops += 1
        if hops > MAX_LINK_HOPS:
            raise ValueError(f"{f.name}: more than {MAX_LINK_HOPS} HDF5 links on the path "
                             f"'{path}'")
        if kind == "soft":
            f, group = _walk(f, group, target, hops)
        else:
            ext = _open_external(f, target[0])
            f, group = _walk(ext, ext.root, target[1], hops)
    return f, group


def _external_bytes(f: _File, b: bytes, nbytes: int) -> bytes:
    """The bytes of a dataset in external files (the External Data Files
    message): its slots in order, each file found from the working
    directory, as HDF5 finds them with no prefix set."""
    used, heap = _uint(b, 6, 2), f.addr_in(b, 8)
    p, out = 8 + f.so, []
    for i in range(used):
        q = p + i * 3 * f.sl
        name = f._heap_string(heap, _uint(b, q, f.sl))
        offset, size = _uint(b, q + f.sl, f.sl), _uint(b, q + 2 * f.sl, f.sl)
        want = nbytes - sum(map(len, out))
        if size != (1 << 8 * f.sl) - 1:
            want = min(want, size)
        try:
            with open(name, "rb") as fh:
                fh.seek(offset)
                out.append(fh.read(want))
        except OSError as err:
            raise ValueError(f"{f.name}: cannot read the HDF5 external storage file "
                             f"'{name}': {err}") from None
    raw = b"".join(out)
    if len(raw) < nbytes:
        raise ValueError(f"{f.name}: HDF5 external storage holds {len(raw)} bytes, not {nbytes}")
    return raw


def read_dataset(src: Source, name: str) -> np.ndarray:
    """h5py.File(src)[name][()] (see the module docstring)."""
    data, fname = read_source(src)
    path = None if isinstance(src, (bytes, bytearray)) else os.fspath(src)
    f, addr = _walk(_File(data, fname, path), 0, "/" + name)
    shape = maxshape = t = layout = fill = efl = None
    pipeline = []
    for mtype, b in f.messages(addr):
        if mtype == 0x01:
            version, rank, flags = b[0], b[1], b[2]
            p = 8 if version == 1 else 4
            if version == 2 and b[3] == 2:
                shape = None
                continue
            sl = f.sl
            shape = tuple(_uint(b, p + sl * i, sl) for i in range(rank))
            maxshape = (tuple(_uint(b, p + sl * (rank + i), sl) for i in range(rank))
                        if flags & 1 else shape)
            maxshape = tuple(UNDEF if m == (1 << 8 * sl) - 1 else m for m in maxshape)
        elif mtype == 0x03:
            t = _parse_type(f, b)[0]
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
            efl = b
    if layout is None or t is None:
        raise ValueError(f"{f.name}: '{name}' is not an HDF5 dataset")
    if shape is None:
        f.fail("null dataspace")
    rank = len(shape)
    esize = t.size
    n = int(np.prod(shape, dtype=np.int64))
    version, cls = layout[0], layout[1]
    if version < 3:
        f.fail(f"data layout message version {version}")

    def elements(raw: bytes, count: int, dims) -> np.ndarray:
        arr = t.read(f, raw, count)
        return arr.reshape(tuple(dims) + arr.shape[1:])

    if cls == 0:
        size = _uint(layout, 2, 2)
        return elements(layout[4:4 + size], n, shape)
    if cls == 1:
        if efl is not None:
            return elements(_external_bytes(f, efl, n * esize), n, shape)
        a = f.addr_in(layout, 2)
        if a == UNDEF:
            return _filled(f, shape, t, fill)
        p = f.at(a)
        return elements(_data_of(f, p, n * esize), n, shape)
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
    out = _filled(f, shape, t, fill)
    if index == UNDEF:
        return out
    nchunks = [-(-s // c) for s, c in zip(shape, cdims)]
    maxchunks = [-(-m // c) if m != UNDEF else None for m, c in zip(maxshape, cdims)]
    celems = int(np.prod(cdims))
    chunk_bytes = celems * esize
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
        raw = _data_of(f, f.at(a), size)
        if filtered:
            raw = _unfilter(f, raw, pipeline, mask, chunk_bytes)
        if len(raw) < chunk_bytes:
            raise ValueError(f"{f.name}: truncated HDF5 chunk")
        block = elements(raw[:chunk_bytes], celems, cdims)
        lo = [s * c for s, c in zip(scaled, cdims)]
        hi = [min(l + c, s) for l, c, s in zip(lo, cdims, shape)]
        if any(l >= h for l, h in zip(lo, hi)):
            continue
        out[tuple(slice(l, h) for l, h in zip(lo, hi))] = block[
            tuple(slice(0, h - l) for l, h in zip(lo, hi))]
    return out


def _data_of(f: _File, pos: int, nbytes: int) -> bytes:
    raw = f.data[pos:pos + nbytes]
    if len(raw) < nbytes:
        raise ValueError(f"{f.name}: truncated HDF5 data")
    return raw


def _filled(f: _File, shape, t: _Type, fill) -> np.ndarray:
    """The dataset before its chunks: every element the fill value (zero
    bytes where none is set)."""
    one = fill if fill is not None and len(fill) == t.size else bytes(t.size)
    v = t.read(f, one, 1)
    out = np.empty(tuple(shape) + v.shape[1:], v.dtype)
    if v.dtype == object:
        for idx in np.ndindex(*shape):
            out[idx] = v[0]
    else:
        out[...] = v[0]
    return out


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

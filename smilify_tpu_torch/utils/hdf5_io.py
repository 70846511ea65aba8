"""HDF5 files in numpy and the standard library, without h5py.

The card's machine has no h5py, and the project's data pipeline is built on
HDF5 files (the multi-view and single-view stores, SLEAP's analysis ``.h5``
and native ``.slp`` exports, triangulated points). This module reads and
writes the subset of the format that h5py writes for those files, through an
API that is the subset of h5py's the port calls, and returns values as h5py 3
returns them:

  * :class:`File` ``(path, "r")`` reads through ``mmap``: superblock v0-v3,
    object headers v1 and v2 (continuation blocks included), groups as
    symbol tables (v1 B-tree, symbol-table nodes, local heap) or compact
    link messages, attribute messages v1-v3, datatypes (fixed-point of 1-8
    bytes in either byte order, IEEE float, fixed and variable-length
    strings, enum, compound, array, variable-length sequence), scalar,
    simple and null dataspaces, and compact, contiguous and chunked layouts
    (v1 B-tree index) with the deflate, shuffle and fletcher32 filters
    (the checksum is verified). Anything else raises ``NotImplementedError``
    naming the feature: dense link or attribute storage, a layout-v4 chunk
    index, another filter, a user block, shared messages.
  * :class:`File` ``(path, "w")`` buffers groups, datasets and attributes
    until ``close`` and writes the file h5py writes by default (superblock
    v0, v1 object headers, symbol-table groups, contiguous datasets,
    variable-length data in global heap collections, attributes in the
    object header with a continuation block when they overflow the first):
    int8-64 and uint8-64, float16/32/64, h5py's bool enum, null-padded
    fixed-length strings, variable-length strings, variable-length
    sequences of a numeric type and compounds of numeric fields.

Values as h5py 3 returns them: fixed-length strings as numpy ``S`` arrays,
variable-length strings in a dataset as an object array of ``bytes`` and in
an attribute as ``str``, h5py's bool enum as ``numpy.bool_``,
variable-length sequences as an object array of 1-D arrays, compounds as
structured arrays, scalar attributes as numpy scalars.
"""

from __future__ import annotations

import mmap
import os
import struct
import zlib

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
# a variable-length element on disk: its length, then the global heap ID
_VLEN_ID = np.dtype([("len", "<u4"), ("addr", "<u8"), ("index", "<u4")])


def vlen_dtype(base) -> np.dtype:
    """A variable-length sequence of ``base`` (h5py's ``vlen_dtype``)."""
    return np.dtype("O", metadata={"vlen": np.dtype(base)})


def string_dtype(encoding: str = "utf-8") -> np.dtype:
    """A variable-length string, UTF-8 or ASCII (h5py's ``string_dtype``)."""
    if encoding not in ("utf-8", "ascii"):
        raise ValueError(f"string encoding {encoding!r}: 'utf-8' or 'ascii'")
    return np.dtype("O", metadata={"vlen": str if encoding == "utf-8" else bytes})


class Empty:
    """An attribute with a null dataspace: a type and no value (h5py.Empty)."""

    def __init__(self, dtype):
        self.dtype = np.dtype(dtype)

    def __eq__(self, other):
        return isinstance(other, Empty) and other.dtype == self.dtype

    def __repr__(self):
        return f"Empty(dtype={self.dtype!r})"


def _pad8(n: int) -> int:
    return (n + 7) & ~7


def _cstring(buf, pos: int) -> bytes:
    end = buf.find(b"\0", pos)
    return bytes(buf[pos:end])


# ---------------------------------------------------------------------------
# reader: datatypes, dataspaces, filters
# ---------------------------------------------------------------------------


class _Type:
    """A datatype as read: ``np`` views the stored bytes; ``kind`` is
    ``"plain"`` (``np`` is the value's dtype), ``"vstr"`` or ``"vseq"``
    (``np`` is the heap ID and ``base`` the element's type); ``utf8``: the
    strings' character set."""

    def __init__(self, np_dtype, kind="plain", base=None, utf8=False):
        self.np = np.dtype(np_dtype)
        self.kind = kind
        self.base = base
        self.utf8 = utf8

    @property
    def public(self) -> np.dtype:
        """The dtype h5py reports for this type."""
        if self.kind == "vstr":
            return string_dtype("utf-8" if self.utf8 else "ascii")
        if self.kind == "vseq":
            return vlen_dtype(self.base.np)
        return self.np


_TYPE_CLASSES = {2: "time", 4: "bitfield", 5: "opaque", 7: "reference"}


def _parse_type(b: bytes, p: int = 0):
    """One datatype message body at ``b[p:]`` → (_Type, the end)."""
    cv = b[p]
    cls, ver = cv & 15, cv >> 4
    bits = b[p + 1] | b[p + 2] << 8 | b[p + 3] << 16
    (size,) = struct.unpack_from("<I", b, p + 4)
    q = p + 8
    order = ">" if bits & 1 else "<"
    if cls == 0:                                            # fixed-point
        if size not in (1, 2, 4, 8):
            raise NotImplementedError(f"HDF5 integer of {size} bytes")
        return _Type(f"{order}{'i' if bits & 8 else 'u'}{size}"), q + 4
    if cls == 1:                                            # floating-point
        if bits & 0x40 or size not in (2, 4, 8):
            raise NotImplementedError(f"HDF5 float of {size} bytes (VAX order: {bool(bits & 0x40)})")
        return _Type(f"{order}f{size}"), q + 12
    if cls == 3:                                            # fixed-length string
        encoding = "utf-8" if bits >> 4 & 15 else "ascii"   # tagged as h5py tags it
        return _Type(np.dtype(f"S{size}", metadata={"h5py_encoding": encoding})), q
    if cls == 6:                                            # compound
        names, formats, offsets = [], [], []
        for _ in range(bits & 0xFFFF):
            name = _cstring(b, q)
            q += _pad8(len(name) + 1) if ver < 3 else len(name) + 1
            dims = ()
            if ver == 1:
                off, nd = struct.unpack_from("<IB", b, q)
                dims = struct.unpack_from(f"<{nd}I", b, q + 16)
                q += 32
            elif ver == 2:
                (off,) = struct.unpack_from("<I", b, q)
                q += 4
            else:
                width = 1 if size < 1 << 8 else 2 if size < 1 << 16 else 3 if size < 1 << 24 else 4
                off = int.from_bytes(b[q:q + width], "little")
                q += width
            member, q = _parse_type(b, q)
            if member.kind != "plain":
                raise NotImplementedError("HDF5 variable-length member of a compound")
            names.append(name.decode())
            formats.append((member.np, dims) if dims else member.np)
            offsets.append(off)
        return _Type({"names": names, "formats": formats, "offsets": offsets,
                      "itemsize": size}), q
    if cls == 8:                                            # enum
        base, q = _parse_type(b, q)
        names = []
        for _ in range(bits & 0xFFFF):
            name = _cstring(b, q)
            q += _pad8(len(name) + 1) if ver < 3 else len(name) + 1
            names.append(name)
        n = len(names)
        values = np.frombuffer(b, base.np, n, q).tolist()
        q += n * base.np.itemsize
        if base.np.itemsize == 1 and dict(zip(names, values)) == {b"FALSE": 0, b"TRUE": 1}:
            return _Type(np.bool_), q                       # h5py's bool
        return base, q
    if cls == 9:                                            # variable-length
        base, q = _parse_type(b, q)
        if bits & 15 == 1:
            return _Type(_VLEN_ID, "vstr", base, utf8=bool(bits >> 8 & 15)), q
        if base.kind != "plain":
            raise NotImplementedError("HDF5 variable-length sequence of a variable-length type")
        return _Type(_VLEN_ID, "vseq", base), q
    if cls == 10:                                           # array
        nd = b[q]
        q += 4 if ver < 3 else 1
        dims = struct.unpack_from(f"<{nd}I", b, q)
        q += 4 * nd * (2 if ver < 3 else 1)                 # v2 also lists a permutation
        base, q = _parse_type(b, q)
        if base.kind != "plain":
            raise NotImplementedError("HDF5 array of a variable-length type")
        return _Type((base.np, dims)), q
    raise NotImplementedError(f"HDF5 datatype class {_TYPE_CLASSES.get(cls, cls)}")


def _parse_space(b: bytes):
    """A dataspace message body → the shape, or None for a null dataspace."""
    ver, nd = b[0], b[1]
    if ver == 1:
        p = 8
    elif ver == 2:
        if b[3] == 2:
            return None
        p = 4
    else:
        raise NotImplementedError(f"HDF5 dataspace message version {ver}")
    return tuple(struct.unpack_from(f"<{nd}Q", b, p))


def _parse_filters(b: bytes):
    """A filter pipeline message → [(filter id, client data)]."""
    ver, n = b[0], b[1]
    p = 8 if ver == 1 else 2
    out = []
    for _ in range(n):
        (fid,) = struct.unpack_from("<H", b, p)
        p += 2
        name_len = 0
        if ver == 1 or fid >= 256:
            (name_len,) = struct.unpack_from("<H", b, p)
            p += 2
        _flags, nvals = struct.unpack_from("<HH", b, p)
        p += 4 + (_pad8(name_len) if ver == 1 else name_len)
        vals = struct.unpack_from(f"<{nvals}I", b, p)
        p += 4 * nvals + (4 if ver == 1 and nvals % 2 else 0)
        if fid not in (1, 2, 3):
            names = {4: "szip", 5: "nbit", 6: "scaleoffset", 32000: "lzf", 32001: "blosc"}
            raise NotImplementedError(f"HDF5 filter {fid} ({names.get(fid, 'unknown')})")
        out.append((fid, vals))
    return out


def fletcher32(data: bytes) -> int:
    """HDF5's Fletcher-32 checksum (``H5_checksum_fletcher32``): 16-bit
    big-endian words, sums folded every 360 words."""
    n = len(data) // 2
    words = np.frombuffer(data, ">u2", n).astype(np.int64)
    s1 = s2 = 0
    for start in range(0, n, 360):
        run = np.cumsum(words[start:start + 360])
        s2 = (s2 + len(run) * s1 + int(run.sum())) & 0xFFFFFFFF
        s1 = (s1 + int(run[-1])) & 0xFFFFFFFF
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    if len(data) % 2:
        s1 += data[-1] << 8
        s2 += s1
        s1 = (s1 & 0xFFFF) + (s1 >> 16)
        s2 = (s2 & 0xFFFF) + (s2 >> 16)
    s1 = (s1 & 0xFFFF) + (s1 >> 16)
    s2 = (s2 & 0xFFFF) + (s2 >> 16)
    return s2 << 16 | s1


def _unfilter(buf: bytes, filters, mask: int) -> bytes:
    for i in reversed(range(len(filters))):
        if mask >> i & 1:
            continue
        fid, vals = filters[i]
        if fid == 1:
            buf = zlib.decompress(buf)
        elif fid == 2:
            size = vals[0]
            n = len(buf) // size
            planes = np.frombuffer(buf, np.uint8, n * size).reshape(size, n)
            buf = planes.T.tobytes() + buf[n * size:]
        else:
            (stored,) = struct.unpack("<I", buf[-4:])
            buf = buf[:-4]
            want = fletcher32(buf)
            # HDF5 before 1.6.3 wrote the sum with the bytes of each half swapped
            w = struct.pack("<I", want)
            swapped = int.from_bytes(bytes((w[1], w[0], w[3], w[2])), "little")
            if stored not in (want, swapped):
                raise ValueError(f"HDF5 fletcher32 checksum mismatch ({stored:#010x} != {want:#010x})")
    return buf


def _fill(b: bytes):
    """A fill value message (new style) → its bytes, or None (zeros)."""
    ver = b[0]
    if ver in (1, 2):
        if ver == 2 and not b[3]:
            return None
        (n,) = struct.unpack_from("<I", b, 4)
        return b[8:8 + n] if n else None
    if b[1] & 0x20:
        (n,) = struct.unpack_from("<I", b, 2)
        return b[6:6 + n] if n else None
    return None


# ---------------------------------------------------------------------------
# reader: the file, its objects and heaps
# ---------------------------------------------------------------------------


class _Reader:
    """An open file: its map, the root's address and the parsed objects
    and global heap collections, each read once."""

    def __init__(self, path: str):
        with open(path, "rb") as fh:
            size = os.fstat(fh.fileno()).st_size
            if size < len(SIGNATURE):
                raise OSError(f"{path}: not an HDF5 file ({size} bytes)")
            self.mm = mmap.mmap(fh.fileno(), 0, access=mmap.ACCESS_READ)
        self.objects = {}
        self.collections = {}
        try:
            self.root = self._superblock(path)
        except BaseException:
            self.mm.close()
            raise

    def _superblock(self, path: str) -> int:
        mm = self.mm
        if mm[:8] != SIGNATURE:
            at = 512
            while at + 8 <= len(mm):
                if mm[at:at + 8] == SIGNATURE:
                    raise NotImplementedError(f"HDF5 user block ({at} bytes) in {path}")
                at *= 2
            raise OSError(f"{path}: not an HDF5 file")
        ver = mm[8]
        if ver in (0, 1):
            sizes, p = (mm[13], mm[14]), 24 + 4 * ver
            base = struct.unpack_from("<Q", mm, p)[0]
            root = struct.unpack_from("<Q", mm, p + 32 + 8)[0]
        elif ver in (2, 3):
            sizes = (mm[9], mm[10])
            base, _ext, _eof, root = struct.unpack_from("<4Q", mm, 12)
        else:
            raise NotImplementedError(f"HDF5 superblock version {ver}")
        if sizes != (8, 8):
            raise NotImplementedError(f"HDF5 offsets and lengths of {sizes} bytes")
        if base:
            raise NotImplementedError(f"HDF5 user block (base address {base})")
        return root

    def close(self):
        self.objects.clear()
        self.collections.clear()
        try:
            self.mm.close()
        except BufferError:          # an array still views the map: it closes with it
            pass

    def messages(self, addr: int):
        """An object header's messages, continuation blocks followed →
        [(type, body)]."""
        mm = self.mm
        out = []
        if mm[addr:addr + 4] == b"OHDR":                   # version 2
            flags = mm[addr + 5]
            p = addr + 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
            width = 1 << (flags & 3)
            size = int.from_bytes(mm[p:p + width], "little")
            chunks = [(p + width, p + width + size)]
            head = 6 if flags & 4 else 4
            while chunks:
                q, end = chunks.pop(0)
                while q + head <= end:
                    kind, n, mflags = mm[q], struct.unpack_from("<H", mm, q + 1)[0], mm[q + 3]
                    q += head
                    self._message(out, chunks, kind, mflags, mm[q:q + n], 4)
                    q += n
            return out
        if mm[addr] != 1:
            raise NotImplementedError(f"HDF5 object header version {mm[addr]}")
        count, _refs, size = struct.unpack_from("<HII", mm, addr + 2)
        chunks = [(addr + 16, addr + 16 + size)]
        while chunks and count:
            q, end = chunks.pop(0)
            while q + 8 <= end and count:
                kind, n, mflags = struct.unpack_from("<HHB", mm, q)
                q += 8
                self._message(out, chunks, kind, mflags, mm[q:q + n], 0)
                q += n
                count -= 1
        return out

    @staticmethod
    def _message(out, chunks, kind, flags, body, skip):
        if kind == 0x10:                                    # continuation
            off, n = struct.unpack_from("<QQ", body)
            chunks.append((off + skip, off + n - skip))     # v2: "OCHK" ... checksum
        elif kind:
            if flags & 2:
                raise NotImplementedError(f"HDF5 shared object header message (type {kind})")
            out.append((kind, body))

    def obj(self, addr: int, name: str):
        o = self.objects.get(addr)
        if o is None:
            msgs = self.messages(addr)
            kinds = {k for k, _ in msgs}
            if 8 in kinds:
                o = Dataset(self, name, msgs)
            elif kinds & {0x02, 0x06, 0x11}:
                o = Group(self, addr, name)
            elif 3 in kinds:
                raise NotImplementedError(f"HDF5 committed datatype {name}")
            else:
                raise NotImplementedError(f"HDF5 object {name} with messages {sorted(kinds)}")
            self.objects[addr] = o
        return o

    def links(self, msgs):
        """A group's links → {name: object header address}, sorted by name."""
        out = {}
        for kind, b in msgs:
            if kind == 0x11:
                out.update(self._symbol_table(*struct.unpack_from("<QQ", b)))
            elif kind == 0x02:
                (heap,) = struct.unpack_from("<Q", b, 2 + (8 if b[1] & 1 else 0))
                if heap != UNDEF:
                    raise NotImplementedError("HDF5 dense link storage (fractal heap)")
            elif kind == 0x06:
                flags, p, ltype = b[1], 2, 0
                if flags & 8:
                    ltype, p = b[p], p + 1
                p += (8 if flags & 4 else 0) + (1 if flags & 16 else 0)
                width = 1 << (flags & 3)
                n = int.from_bytes(b[p:p + width], "little")
                name = bytes(b[p + width:p + width + n]).decode()
                if ltype:
                    what = {1: "soft", 64: "external"}.get(ltype, f"type-{ltype}")
                    raise NotImplementedError(f"HDF5 {what} link {name!r}")
                out[name] = struct.unpack_from("<Q", b, p + width + n)[0]
        return dict(sorted(out.items(), key=lambda kv: kv[0].encode()))

    def _symbol_table(self, btree: int, heap: int):
        mm = self.mm
        if mm[heap:heap + 4] != b"HEAP":
            raise OSError(f"HDF5 local heap expected at {heap}")
        (data,) = struct.unpack_from("<Q", mm, heap + 24)
        out = {}

        def walk(addr):
            if mm[addr:addr + 4] != b"TREE" or mm[addr + 4] != 0:
                raise OSError(f"HDF5 group B-tree node expected at {addr}")
            level, n = mm[addr + 5], struct.unpack_from("<H", mm, addr + 6)[0]
            for i in range(n):
                (child,) = struct.unpack_from("<Q", mm, addr + 32 + 16 * i)
                if level:
                    walk(child)
                    continue
                if mm[child:child + 4] != b"SNOD":
                    raise OSError(f"HDF5 symbol table node expected at {child}")
                for j in range(struct.unpack_from("<H", mm, child + 6)[0]):
                    off, hdr, cache = struct.unpack_from("<QQI", mm, child + 8 + 40 * j)
                    name = _cstring(mm, data + off).decode()
                    if cache == 2:
                        raise NotImplementedError(f"HDF5 soft link {name!r}")
                    out[name] = hdr

        if btree != UNDEF:
            walk(btree)
        return out

    def chunks(self, addr: int, ndim: int):
        """The chunks under a v1 B-tree node of raw data → (size, filter
        mask, offsets, address) each."""
        mm = self.mm
        if mm[addr:addr + 4] != b"TREE" or mm[addr + 4] != 1:
            raise OSError(f"HDF5 chunk B-tree node expected at {addr}")
        level, n = mm[addr + 5], struct.unpack_from("<H", mm, addr + 6)[0]
        step = 16 + 8 * (ndim + 1)                          # key + child
        for i in range(n):
            p = addr + 24 + step * i
            size, mask = struct.unpack_from("<II", mm, p)
            offsets = struct.unpack_from(f"<{ndim}Q", mm, p + 8)
            (child,) = struct.unpack_from("<Q", mm, p + step - 8)
            if level:
                yield from self.chunks(child, ndim)
            else:
                yield size, mask, offsets, child

    def heap_object(self, addr: int, index: int) -> int:
        """The file offset of object ``index`` of the global heap collection
        at ``addr`` (a collection is indexed once)."""
        col = self.collections.get(addr)
        if col is None:
            mm = self.mm
            if mm[addr:addr + 4] != b"GCOL":
                raise OSError(f"HDF5 global heap collection expected at {addr}")
            end = addr + struct.unpack_from("<Q", mm, addr + 8)[0]
            col, p = {}, addr + 16
            while p + 16 <= end:
                i, _refs, _res, n = struct.unpack_from("<HHIQ", mm, p)
                if i == 0:                                  # free space: the rest
                    break
                col[i] = p + 16
                p += 16 + _pad8(n)
            self.collections[addr] = col
        return col[index]

    def vlen(self, t: _Type, ids: np.ndarray) -> np.ndarray:
        """Heap IDs → an object array of ``bytes`` (strings) or 1-D arrays."""
        out = np.empty(ids.shape, object)
        flat = out.reshape(-1)
        base, mm = t.base.np, self.mm
        for i, (n, addr, index) in enumerate(ids.reshape(-1).tolist()):
            if t.kind == "vstr":
                flat[i] = mm[(p := self.heap_object(addr, index)):p + n] if n else b""
            else:
                flat[i] = (np.frombuffer(mm, base, n, self.heap_object(addr, index)).copy()
                           if n else np.zeros(0, base))
        return out.view(t.public)

    def attributes(self, msgs):
        """An object's attribute messages → {name: body}, sorted by name."""
        out = {}
        for kind, b in msgs:
            if kind == 0x15:
                (heap,) = struct.unpack_from("<Q", b, 2 + (2 if b[1] & 1 else 0))
                if heap != UNDEF:
                    raise NotImplementedError("HDF5 dense attribute storage (fractal heap)")
            elif kind == 0x0C:
                ver = b[0]
                if ver > 1 and b[1] & 3:
                    raise NotImplementedError("HDF5 attribute with a shared datatype or dataspace")
                (n,) = struct.unpack_from("<H", b, 2)
                p = 8 + (ver == 3)
                out[bytes(b[p:p + n - 1]).decode()] = b
        return dict(sorted(out.items()))

    def attribute(self, b: bytes):
        """An attribute message → its value as h5py returns it."""
        ver = b[0]
        n, tn, sn = struct.unpack_from("<HHH", b, 2)
        step = _pad8 if ver == 1 else (lambda k: k)
        p = 8 + (ver == 3) + step(n)
        t, _ = _parse_type(b, p)
        p += step(tn)
        shape = _parse_space(b[p:p + sn])
        p += step(sn)
        if shape is None:
            return Empty(t.public)
        raw = np.frombuffer(b, t.np, int(np.prod(shape)), p).reshape(shape)
        if t.kind == "plain":
            value = raw.copy()
        else:
            value = self.vlen(t, raw)
            if t.kind == "vstr" and value.size:
                value = np.vectorize(lambda s: s.decode("utf-8", "surrogateescape"),
                                     otypes=[object])(value).view(t.public)
        return value[()] if shape == () else value


# ---------------------------------------------------------------------------
# reader: groups and datasets
# ---------------------------------------------------------------------------


def _join(parent: str, name: str) -> str:
    return parent.rstrip("/") + "/" + name


class AttributeManager:
    """An object's attributes: read from its header, or (a file being
    written) the values set so far."""

    def __init__(self, reader=None, msgs=None):
        self._reader = reader
        self._bodies = reader.attributes(msgs) if reader is not None else {}
        self._values = {}

    def __getitem__(self, name: str):
        if self._reader is None:
            arr = self._values[name]
            return arr[()] if arr.ndim == 0 else arr
        return self._reader.attribute(self._bodies[name])

    def __setitem__(self, name: str, value):
        if self._reader is not None:
            raise OSError("the file is open read-only")
        arr = _as_array(value)
        _encode_type(arr.dtype)                             # h5py's TypeError, now
        if arr.size * (16 if arr.dtype.kind == "O" else arr.dtype.itemsize) > 0xFF00:
            raise NotImplementedError(f"attribute {name!r} over 64 KiB "
                                      "(HDF5 dense attribute storage)")
        self._values[name] = arr

    def keys(self):
        return sorted(self._values) if self._reader is None else list(self._bodies)

    def __iter__(self):
        return iter(self.keys())

    def __len__(self):
        return len(self.keys())

    def __contains__(self, name) -> bool:
        return name in self.keys()

    def items(self):
        return [(k, self[k]) for k in self.keys()]

    def get(self, name, default=None):
        return self[name] if name in self else default


class _Node:
    """What groups of a file being read or written share: h5py's mapping
    of names and paths."""

    def _child(self, name):
        raise NotImplementedError

    def _names(self):
        raise NotImplementedError

    def __getitem__(self, path):
        if isinstance(path, bytes):
            path = path.decode()
        node = self._top() if path.startswith("/") else self
        for part in path.split("/"):
            if part in ("", "."):
                continue
            if not isinstance(node, _Node):
                raise KeyError(f"{node.name} is a dataset, not a group")
            node = node._child(part)
        return node

    def _top(self):
        return self

    def __contains__(self, path) -> bool:
        try:
            self[path]
        except KeyError:
            return False
        return True

    def keys(self):
        return list(self._names())

    def __iter__(self):
        return iter(self._names())

    def __len__(self):
        return len(self._names())

    def items(self):
        return [(k, self[k]) for k in self._names()]

    def get(self, path, default=None):
        try:
            return self[path]
        except KeyError:
            return default

    def visititems(self, func):
        """``func(name, object)`` for every object below, each once, in
        name order and parents first; stops at the first result not None."""
        seen = set()

        def walk(group, prefix):
            for name in group._names():
                obj = group[name]
                if id(obj) in seen:
                    continue
                seen.add(id(obj))
                found = func(prefix + name, obj)
                if found is None and isinstance(obj, _Node):
                    found = walk(obj, prefix + name + "/")
                if found is not None:
                    return found
            return None

        return walk(self, "")


class Group(_Node):
    """A group of a file being read."""

    def __init__(self, reader: _Reader, addr: int, name: str):
        self._r, self._addr, self.name = reader, addr, name
        self._msgs = self._links = self._attrs = None

    def _messages(self):
        if self._msgs is None:
            self._msgs = self._r.messages(self._addr)
        return self._msgs

    def _names(self):
        if self._links is None:
            self._links = self._r.links(self._messages())
        return self._links

    def _child(self, name):
        links = self._names()
        if name not in links:
            raise KeyError(f"Unable to open object {name!r} in {self.name!r} (it does not exist)")
        return self._r.obj(links[name], _join(self.name, name))

    def _top(self):
        return self._r.obj(self._r.root, "/")

    @property
    def attrs(self) -> AttributeManager:
        if self._attrs is None:
            self._attrs = AttributeManager(self._r, self._messages())
        return self._attrs

    def __repr__(self):
        return f"<HDF5 group {self.name!r} ({len(self)} members)>"


class Dataset:
    """A dataset of a file being read: ``shape``, ``dtype``, ``attrs`` and
    numpy indexing (``()``, ``...``, ints, slices, sorted int arrays)."""

    def __init__(self, reader: _Reader, name: str, msgs):
        self._r, self.name, self._msgs = reader, name, msgs
        self._attrs = self._cache = None
        fill, self._filters, layout = None, [], None
        for kind, b in msgs:
            if kind == 1:
                self.shape = _parse_space(b)
            elif kind == 3:
                self._type, _ = _parse_type(b)
            elif kind == 8:
                layout = b
            elif kind == 11:
                self._filters = _parse_filters(b)
            elif kind == 5:
                fill = _fill(b)
        dt = self._type.np
        self._fill = (np.frombuffer(fill, dt, 1)[0] if fill is not None and len(fill) == dt.itemsize
                      and self._type.kind == "plain" else None)
        self._parse_layout(layout)

    def _parse_layout(self, b):
        ver, self.chunks = b[0], None
        if ver in (1, 2):
            nd, cls = b[1], b[2]
            p = 8 + (8 if cls else 0)
            (self._addr,) = struct.unpack_from("<Q", b, 8) if cls else (UNDEF,)
            dims = struct.unpack_from(f"<{nd}I", b, p)
            if cls == 0:
                (n,) = struct.unpack_from("<I", b, p + 4 * nd)
                self._compact = b[p + 4 * nd + 4:p + 4 * nd + 4 + n]
        elif ver in (3, 4):
            cls = b[1]
            if cls == 0:
                (n,) = struct.unpack_from("<H", b, 2)
                self._compact = b[4:4 + n]
            elif cls == 1:
                (self._addr,) = struct.unpack_from("<Q", b, 2)
            elif cls == 2:
                if ver == 4:
                    raise NotImplementedError(f"HDF5 layout-v4 chunk index ({self.name})")
                nd = b[2]
                (self._addr,) = struct.unpack_from("<Q", b, 3)
                dims = struct.unpack_from(f"<{nd}I", b, 11)
        else:
            raise NotImplementedError(f"HDF5 layout message version {ver}")
        if cls not in (0, 1, 2):
            raise NotImplementedError(f"HDF5 layout class {cls} (virtual dataset {self.name})")
        self._layout = cls
        if cls == 2:
            self.chunks = tuple(dims[:-1])

    @property
    def dtype(self) -> np.dtype:
        return self._type.public

    @property
    def size(self) -> int:
        return int(np.prod(self.shape))

    def __len__(self):
        if not self.shape:
            raise TypeError("a scalar dataset has no length")
        return self.shape[0]

    @property
    def attrs(self) -> AttributeManager:
        if self._attrs is None:
            self._attrs = AttributeManager(self._r, self._msgs)
        return self._attrs

    def _blank(self):
        dt = self._type.np
        return (np.full(self.shape, self._fill, dt) if self._fill is not None
                else np.zeros(self.shape, dt))

    def _stored(self) -> np.ndarray:
        """The whole dataset in its stored type: a view of the map
        (contiguous), or decoded once (compact, chunked)."""
        dt = self._type.np
        if self._layout == 1:
            if self._addr == UNDEF:
                return self._blank()
            return np.ndarray(self.shape, dt, buffer=self._r.mm, offset=self._addr)
        if self._cache is None:
            if self._layout == 0:
                self._cache = np.frombuffer(self._compact, dt, self.size).reshape(self.shape)
            else:
                self._cache = self._read_chunks()
        return self._cache

    def _read_chunks(self) -> np.ndarray:
        dt, chunk = self._type.np, self.chunks
        grid = [-(-s // c) * c for s, c in zip(self.shape, chunk)]
        out = (np.full(grid, self._fill, dt) if self._fill is not None else np.zeros(grid, dt))
        count = int(np.prod(chunk))
        if self._addr != UNDEF:
            mm = self._r.mm
            for size, mask, offsets, addr in self._r.chunks(self._addr, len(chunk)):
                buf = _unfilter(mm[addr:addr + size], self._filters, mask)
                block = np.frombuffer(buf, dt, count).reshape(chunk)
                out[tuple(slice(o, o + c) for o, c in zip(offsets, chunk))] = block
        return out[tuple(slice(0, s) for s in self.shape)]

    def __getitem__(self, key):
        if self.shape is None:
            return Empty(self.dtype)
        raw = self._stored()[key]
        if self._type.kind == "plain":
            return raw.copy() if isinstance(raw, np.ndarray) else raw
        out = self._r.vlen(self._type, np.asarray(raw))
        return out if isinstance(raw, np.ndarray) else out[()]

    def __repr__(self):
        return f"<HDF5 dataset {self.name!r}: shape {self.shape}, type {self.dtype}>"


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

_FLOAT_LAYOUT = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127), 8: (63, 52, 11, 52, 1023)}
_GROUP_LEAF_K = 4          # a symbol table node holds 2K links
_GROUP_NODE_K = 16         # a group B-tree node holds 2K children
_COLLECTION = 4096         # the least size of a global heap collection
_FIRST_CHUNK = 512         # object header bytes before a continuation block


def _item_type(data):
    """The one Python type of a list's or object array's items (h5py's
    ``find_item_type``), else None."""
    if isinstance(data, np.ndarray):
        if data.dtype.kind != "O" or (data.dtype.metadata or {}).get("vlen") or not data.size:
            return None
        kinds = {type(e) for e in data.flat}
    elif isinstance(data, (list, tuple)):
        kinds = {_item_type(e) for e in data}
    else:
        return type(data)
    return kinds.pop() if len(kinds) == 1 else None


def _as_array(data, dtype=None) -> np.ndarray:
    """A value as h5py converts it for a new dataset or attribute: ``str``
    (and lists of it) to variable-length UTF-8 strings, ``bytes`` to
    variable-length ASCII strings, the rest through ``numpy.asarray``."""
    if dtype is None:
        dtype = {str: string_dtype(), bytes: string_dtype("ascii")}.get(_item_type(data))
    arr = np.asarray(data, dtype=dtype, order="C")
    if dtype is not None and np.dtype(dtype).kind == "O":
        arr = arr.view(dtype)
    return arr


def _int_type(dt: np.dtype) -> bytes:
    order = 1 if dt.byteorder == ">" else 0
    return bytes((0x10, order | (8 if dt.kind == "i" else 0), 0, 0)) + \
        struct.pack("<IHH", dt.itemsize, 0, 8 * dt.itemsize)


def _encode_type(dt: np.dtype) -> bytes:
    """A numpy dtype → its datatype message (h5py's choice of HDF5 type);
    a TypeError for one h5py has no HDF5 type for."""
    dt = np.dtype(dt)
    if dt.kind == "O":
        vlen = (dt.metadata or {}).get("vlen")
        if vlen is str or vlen is bytes:
            return bytes((0x19, 1, 1 if vlen is str else 0, 0)) + struct.pack("<I", 16) + \
                _int_type(np.dtype(np.uint8))
        if vlen is not None and np.dtype(vlen).kind in "iufb":
            return bytes((0x19, 0, 0, 0)) + struct.pack("<I", 16) + _encode_type(np.dtype(vlen))
        raise TypeError(f"Object dtype {dt!r} has no native HDF5 equivalent")
    if dt.kind == "b":
        return bytes((0x18, 2, 0, 0)) + struct.pack("<I", 1) + _int_type(np.dtype(np.int8)) + \
            b"FALSE\0\0\0TRUE\0\0\0\0" + b"\0\1"
    if dt.kind in "iu" and dt.itemsize in (1, 2, 4, 8):
        return _int_type(dt)
    if dt.kind == "f" and dt.itemsize in _FLOAT_LAYOUT:
        sign, exp_at, exp_bits, mant_bits, bias = _FLOAT_LAYOUT[dt.itemsize]
        return bytes((0x11, (1 if dt.byteorder == ">" else 0) | 0x20, sign, 0)) + \
            struct.pack("<IHHBBBBI", dt.itemsize, 0, 8 * dt.itemsize, exp_at, exp_bits, 0,
                        mant_bits, bias)
    if dt.kind == "S" and dt.itemsize:
        return bytes((0x13, 1, 0, 0)) + struct.pack("<I", dt.itemsize)       # null-padded ASCII
    if dt.names and not any(dt.fields[n][0].shape for n in dt.names):
        body = b""
        for name in dt.names:
            field, offset = dt.fields[name][:2]
            if field.kind not in "iufb":
                raise TypeError(f"No conversion path for compound field {name!r}: {field!r}")
            encoded = name.encode() + b"\0"
            body += encoded.ljust(_pad8(len(encoded)), b"\0") + struct.pack("<I28x", offset) + \
                _encode_type(field)
        n = len(dt.names)
        return bytes((0x16, n & 0xFF, n >> 8, 0)) + struct.pack("<I", dt.itemsize) + body
    raise TypeError(f"No conversion path for dtype: {dt!r}")


def _encode_space(shape) -> bytes:
    nd = len(shape)
    return bytes((1, nd, 1 if nd else 0, 0, 0, 0, 0, 0)) + struct.pack(f"<{2 * nd}Q", *shape, *shape)


def _padded(b: bytes) -> bytes:
    return b + b"\0" * (_pad8(len(b)) - len(b))


class WriteDataset:
    """A dataset of a file being written: its values are a numpy array;
    ``ds[i] = buf`` fills a variable-length column."""

    def __init__(self, name: str, data: np.ndarray):
        self.name, self._data = name, data
        self.attrs = AttributeManager()

    shape = property(lambda self: self._data.shape)
    dtype = property(lambda self: self._data.dtype)

    def __len__(self):
        return len(self._data)

    def __getitem__(self, key):
        return self._data[key]

    def __setitem__(self, key, value):
        vlen = (self._data.dtype.metadata or {}).get("vlen")
        if vlen is None or vlen is str or vlen is bytes:
            self._data[key] = value
        else:
            self._data[key] = np.asarray(value, vlen)


class WriteGroup(_Node):
    """A group of a file being written."""

    def __init__(self, name: str):
        self.name = name
        self._members = {}
        self.attrs = AttributeManager()

    def _names(self):
        return sorted(self._members, key=str.encode)

    def _child(self, name):
        if name not in self._members:
            raise KeyError(f"Unable to open object {name!r} in {self.name!r} (it does not exist)")
        return self._members[name]

    def _parent(self, path: str):
        """The group that will hold ``path``'s last part, intermediate
        groups created (as h5py does), and that part."""
        *dirs, leaf = [p for p in path.split("/") if p]
        node = self
        for d in dirs:
            if d not in node._members:
                node._members[d] = WriteGroup(_join(node.name, d))
            node = node._members[d]
            if not isinstance(node, WriteGroup):
                raise TypeError(f"{node.name} is a dataset, not a group")
        if leaf in node._members:
            raise ValueError(f"Unable to create {path!r} (name already exists)")
        return node, leaf

    def create_group(self, path: str) -> "WriteGroup":
        parent, leaf = self._parent(path)
        group = parent._members[leaf] = WriteGroup(_join(parent.name, leaf))
        return group

    def create_dataset(self, path: str, shape=None, dtype=None, data=None) -> WriteDataset:
        if data is not None:
            arr = _as_array(data, dtype)
            if shape is not None:
                arr = arr.reshape(shape)
        else:
            dt = np.dtype("f4" if dtype is None else dtype)
            arr = np.zeros(shape, dt)
            vlen = (dt.metadata or {}).get("vlen")
            if vlen is not None:
                blank = "" if vlen is str else b"" if vlen is bytes else np.zeros(0, vlen)
                flat = arr.reshape(-1)
                for i in range(flat.size):
                    flat[i] = blank
        _encode_type(arr.dtype)                             # h5py's TypeError, now
        parent, leaf = self._parent(path)
        ds = parent._members[leaf] = WriteDataset(_join(parent.name, leaf), arr)
        return ds

    def __setitem__(self, path: str, value):
        self.create_dataset(path, data=value)


class _Writer:
    """Lays out a file being written: every part 8-byte aligned, children
    before the headers that point at them, the superblock last (at 0)."""

    def __init__(self):
        self.parts = []
        self.pos = 96                                       # the superblock's room

    def put(self, b: bytes) -> int:
        addr = self.pos
        b = _padded(b)
        self.parts.append(b)
        self.pos += len(b)
        return addr

    def heap(self, objects):
        """Objects into global heap collections (at least 4096 bytes; a
        larger object gets one of its own) → their (address, index)."""
        ids, i = [], 0
        while i < len(objects):
            start, used = i, 16
            while i < len(objects) and (i == start or used + 16 + _pad8(len(objects[i])) <= _COLLECTION):
                used += 16 + _pad8(len(objects[i]))
                i += 1
            size = max(_COLLECTION, used)
            body = [b"GCOL\1\0\0\0" + struct.pack("<Q", size)]
            for k, o in enumerate(objects[start:i], 1):
                body.append(struct.pack("<HHIQ", k, 0, 0, len(o)) + _padded(o))
                ids.append((self.pos, k))
            free = size - used
            if free >= 16:
                body.append(struct.pack("<HHIQ", 0, 0, 0, free) + b"\0" * (free - 16))
            else:
                body.append(b"\0" * free)
            self.put(b"".join(body))
        return ids

    def values(self, arr: np.ndarray) -> bytes:
        """An array's stored bytes; variable-length items go to the global
        heap first (an empty sequence is a null ID, an empty string an
        empty object, as h5py writes them)."""
        if arr.dtype.kind != "O":
            return np.ascontiguousarray(arr).tobytes()
        vlen = arr.dtype.metadata["vlen"]
        flat = arr.reshape(-1)
        ids = np.zeros(flat.shape, _VLEN_ID)
        objects, where = [], []
        for i, item in enumerate(flat):
            if vlen is str or vlen is bytes:
                b = item.encode() if isinstance(item, str) else bytes(item)
                ids["len"][i] = len(b)
            else:
                seq = np.asarray(item, vlen).reshape(-1)
                ids["len"][i] = len(seq)
                if not len(seq):
                    continue
                b = seq.tobytes()
            objects.append(b)
            where.append(i)
        for i, (addr, index) in zip(where, self.heap(objects)):
            ids["addr"][i], ids["index"][i] = addr, index
        return ids.tobytes()

    def attribute_messages(self, attrs: AttributeManager):
        out = []
        for name in attrs.keys():
            arr = attrs._values[name]
            encoded = name.encode() + b"\0"
            t, space = _encode_type(arr.dtype), _encode_space(arr.shape)
            body = struct.pack("<BBHHH", 1, 0, len(encoded), len(t), len(space)) + \
                _padded(encoded) + _padded(t) + _padded(space) + self.values(arr)
            out.append((0x0C, body, 0))
        return out

    def header(self, msgs) -> int:
        """A v1 object header: the messages that fit in the first chunk,
        the rest in a continuation block right after it."""
        encoded = [struct.pack("<HHB3x", kind, _pad8(len(body)), flags) + _padded(body)
                   for kind, body, flags in msgs]
        first, rest, size = [], [], 0
        for m in encoded:
            if not rest and size + len(m) <= _FIRST_CHUNK - 24:
                first.append(m)
                size += len(m)
            else:
                rest.append(m)
        if rest:
            block = b"".join(rest)
            first.append(struct.pack("<HHB3xQQ", 0x10, 16, 0, self.pos + 16 + size + 24, len(block)))
        body = b"".join(first)
        addr = self.put(struct.pack("<BBHII4x", 1, 0, len(first) + len(rest), 1, len(body)) + body)
        if rest:
            self.put(block)
        return addr

    def dataset(self, ds: WriteDataset) -> int:
        arr = ds._data
        data = self.values(arr)
        addr = self.put(data) if data else UNDEF
        fill = bytes((2, 2, 0 if arr.dtype.kind == "O" else 2, 1, 0, 0, 0, 0))
        return self.header([(0x01, _encode_space(arr.shape), 0), (0x03, _encode_type(arr.dtype), 1),
                            (0x05, fill, 1), (0x08, struct.pack("<BBQQ", 3, 1, addr, len(data)), 0)]
                           + self.attribute_messages(ds.attrs))

    def group(self, group: WriteGroup):
        """A group as a symbol table → (header, B-tree, local heap) addresses."""
        entries = []
        for name in group._names():
            member = group._members[name]
            if isinstance(member, WriteGroup):
                addr, btree, heap = self.group(member)
                entries.append((name, addr, 1, struct.pack("<QQ", btree, heap)))
            else:
                entries.append((name, self.dataset(member), 0, b"\0" * 16))
        names, offsets = bytearray(8), []                   # offset 0: the empty name
        for name, *_ in entries:
            offsets.append(len(names))
            names += _padded(name.encode() + b"\0")
        # the free list's end is offset 1 (HDF5's H5HL_FREE_NULL), not the undefined address
        heap = self.put(b"HEAP\0\0\0\0" + struct.pack("<QQQ", len(names), 1, self.pos + 32)
                        + bytes(names))
        per_node = 2 * _GROUP_LEAF_K
        nodes, keys = [], [0]
        for i in range(0, len(entries), per_node):
            part = entries[i:i + per_node]
            body = b"".join(struct.pack("<QQII", off, addr, cache, 0) + scratch
                            for (_, addr, cache, scratch), off in zip(part, offsets[i:i + per_node]))
            nodes.append(self.put(b"SNOD\1\0" + struct.pack("<H", len(part)) +
                                  body.ljust(40 * per_node, b"\0")))
            keys.append(offsets[i + len(part) - 1])
        btree = self.btree(nodes, keys)
        return (self.header([(0x11, struct.pack("<QQ", btree, heap), 0)]
                            + self.attribute_messages(group.attrs)), btree, heap)

    def btree(self, children, keys, level=0) -> int:
        """Group B-tree nodes over ``children`` (``keys``: one more than the
        children, each child's names ≤ its right key), levels added until
        one node is the root."""
        per_node = 2 * _GROUP_NODE_K
        size = 24 + 8 * (2 * per_node + 1)
        count = max(1, -(-len(children) // per_node))
        first = self.pos
        parents, parent_keys = [], [keys[0]]
        for j in range(count):
            kids = children[j * per_node:(j + 1) * per_node]
            ks = keys[j * per_node:j * per_node + len(kids) + 1]
            left = first + (j - 1) * size if j else UNDEF
            right = first + (j + 1) * size if j + 1 < count else UNDEF
            body = b"".join(struct.pack("<QQ", k, c) for k, c in zip(ks, kids)) + struct.pack("<Q", ks[-1])
            parents.append(self.put((b"TREE\0" + bytes((level,)) + struct.pack("<HQQ", len(kids), left, right)
                                     + body).ljust(size, b"\0")))
            parent_keys.append(ks[-1])
        return parents[0] if count == 1 else self.btree(parents, parent_keys, level + 1)

    def file(self, root: WriteGroup) -> bytes:
        """Lays the tree out → the superblock (v0: group leaf K 4, internal K 16)."""
        addr, btree, heap = self.group(root)
        return (SIGNATURE + bytes((0, 0, 0, 0, 0, 8, 8, 0)) +
                struct.pack("<HHI", _GROUP_LEAF_K, _GROUP_NODE_K, 0) +
                struct.pack("<QQQQ", 0, UNDEF, self.pos, UNDEF) +
                struct.pack("<QQII", 0, addr, 1, 0) + struct.pack("<QQ", btree, heap))


# ---------------------------------------------------------------------------
# the file
# ---------------------------------------------------------------------------


class File:
    """An HDF5 file: ``File(path, "r")`` reads (a :class:`Group`, the root),
    ``File(path, "w")`` writes a new one (a :class:`WriteGroup`), on
    ``close``. A file being read pickles by its path and reopens lazily."""

    def __new__(cls, path, mode: str = "r"):
        if cls is File:
            if mode not in ("r", "w"):
                raise NotImplementedError(
                    f"HDF5 mode {mode!r}: the codec reads ('r') or writes a new file ('w')")
            cls = ReadFile if mode == "r" else WriteFile
        return super().__new__(cls)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class ReadFile(File, Group):
    def __init__(self, path, mode: str = "r"):
        self.filename, self.mode, self.name = os.fspath(path), "r", "/"
        self._reader = None
        self._msgs = self._links = self._attrs = None

    @property
    def _r(self) -> _Reader:
        if self._reader is None:
            self._reader = _Reader(self.filename)
        return self._reader

    @property
    def _addr(self) -> int:
        return self._r.root

    def _top(self):
        return self

    def close(self):
        if self._reader is not None:
            self._reader.close()
        self._reader = None
        self._msgs = self._links = self._attrs = None

    def __reduce__(self):
        return File, (self.filename, "r")


class WriteFile(File, WriteGroup):
    def __init__(self, path, mode: str = "w"):
        WriteGroup.__init__(self, "/")
        self.filename, self.mode = os.fspath(path), "w"
        self._fh = open(self.filename, "wb")

    def close(self):
        if self._fh is None:
            return
        try:
            writer = _Writer()
            superblock = writer.file(self)
            self._fh.write(superblock)
            self._fh.writelines(writer.parts)
        finally:
            self._fh.close()
            self._fh = None

    def __reduce__(self):
        raise TypeError("an HDF5 file being written cannot be pickled")

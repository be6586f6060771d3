"""HDF5 files in numpy: the subset that h5py writes by default and that
:class:`~safeincave_torch.output.SaveFields` needs, written and read without
h5py.

The subset (HDF5 File Format Specification Version 2.0):

* superblock version 0 (II.A), 8-byte addresses and lengths, group leaf
  node K = 4 and internal node K = 16 (h5py's defaults);
* version 1 object headers (IV.A.1.a);
* groups as symbol tables (message 0x0011): a version 1 group B-tree
  (III.A, ``TREE``) over symbol-table nodes (III.B, ``SNOD``) and a local
  heap for the names (III.D, ``HEAP``);
* contiguous datasets: dataspace (0x0001), datatype (0x0003: IEEE float or
  two's-complement integer, little-endian), fill value (0x0005) and layout
  (0x0008, version 3).

:class:`H5Writer` creates intermediate groups, keeps every group's entries in
byte order of their names (``"10"`` sorts before ``"2"``) and builds B-trees
of any depth, so a group holds any number of datasets.  A dataset's header
and data are appended when it is created; :meth:`H5Writer.flush` then
writes the index of each changed group (B-tree nodes, symbol-table nodes
and heap in one block) where nothing points, grows the superblock's
end-of-file address, and only then patches, in place, the fixed-size
addresses that point to the new indexes.  After every ``flush`` the file on
disk is a valid HDF5 file holding every dataset created so far.  Each group
alternates between two index blocks, reallocated at twice the size when
they are outgrown, so the bytes left unused stay within a constant factor
of the index.

:class:`H5Reader` reads the same subset, which covers h5py's default files.
A file that uses anything else (a later superblock, version 2 object
headers, link messages, chunked or compact layout, filters, shared
messages, big-endian or non-numeric types) raises :class:`HDF5FeatureError`
naming the feature.
"""
from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
LEAF_K = 4                      # a symbol-table node holds 2*LEAF_K entries
NODE_K = 16                     # a B-tree node holds 2*NODE_K children
ENTRY_SIZE = 40                 # symbol-table entry
SNOD_SIZE = 8 + 2 * LEAF_K * ENTRY_SIZE
TREE_SIZE = 24 + (4 * NODE_K + 1) * 8
HEAP_HEADER = 32
DATASET_HEADER = 256            # message bytes h5py reserves per dataset
FREE_NULL = 1                   # end of a local heap's free list
EOF_AT = 40                     # superblock offset of the end-of-file address

MSG_NIL, MSG_DATASPACE, MSG_LINK_INFO, MSG_DATATYPE = 0x0, 0x1, 0x2, 0x3
MSG_FILL, MSG_LINK, MSG_EXTERNAL = 0x5, 0x6, 0x7
MSG_LAYOUT, MSG_GROUP_INFO, MSG_FILTERS = 0x8, 0xA, 0xB
MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x10, 0x11

DTYPES = tuple(np.dtype(c) for c in
               ("<f4", "<f8", "<i1", "<i2", "<i4", "<i8",
                "<u1", "<u2", "<u4", "<u8"))
# sign location, exponent location and size, mantissa size, bias
IEEE = {4: (31, 23, 8, 23, 127), 8: (63, 52, 11, 52, 1023)}
TYPE_CLASSES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                6: "compound", 7: "reference", 8: "enumerated",
                9: "variable-length", 10: "array"}


class HDF5FeatureError(ValueError):
    """The file uses an HDF5 feature outside the supported subset."""


def _pad8(n: int) -> int:
    return (n + 7) & ~7


# --------------------------------------------------------------------------- #
# Encoding
# --------------------------------------------------------------------------- #
def _message(mtype: int, body: bytes, flags: int = 0) -> bytes:
    body = body + bytes(_pad8(len(body)) - len(body))
    return struct.pack("<HHB3x", mtype, len(body), flags) + body


def _object_header(messages: list[bytes], reserve: int = 0) -> bytes:
    body = b"".join(messages)
    n = len(messages)
    if len(body) + 8 <= reserve:
        body += _message(MSG_NIL, bytes(reserve - len(body) - 8))
        n += 1
    return struct.pack("<BBHII4x", 1, 0, n, 1, len(body)) + body


def _datatype(dt: np.dtype) -> bytes:
    if dt.kind == "f":
        sign, eloc, esize, msize, bias = IEEE[dt.itemsize]
        return (struct.pack("<4BI", 0x11, 0x20, sign, 0, dt.itemsize)
                + struct.pack("<HH4BI", 0, 8 * dt.itemsize, eloc, esize, 0,
                              msize, bias))
    return (struct.pack("<4BI", 0x10, 0x08 if dt.kind == "i" else 0, 0, 0,
                        dt.itemsize)
            + struct.pack("<HH", 0, 8 * dt.itemsize))


def _dataset_header(shape: tuple, dt: np.dtype, addr: int, nbytes: int):
    rank = len(shape)
    dims = struct.pack(f"<{rank}Q", *shape)
    space = struct.pack("<BBB5x", 1, rank, 1 if rank else 0) + dims \
        + (dims if rank else b"")
    return _object_header([
        _message(MSG_DATASPACE, space),
        _message(MSG_DATATYPE, _datatype(dt), flags=1),
        _message(MSG_FILL, bytes([2, 2, 2, 1, 0, 0, 0, 0]), flags=1),
        _message(MSG_LAYOUT, struct.pack("<BBQQ", 3, 1, addr, nbytes)),
    ], reserve=DATASET_HEADER)


def _group_header(btree: int, heap: int) -> bytes:
    return _object_header([_message(MSG_SYMBOL_TABLE,
                                    struct.pack("<QQ", btree, heap))])


# offset of the symbol-table message's body inside a group's header
STAB_AT = 16 + 8


def _group_index(entries: list[tuple[bytes, int]]):
    """The index of a group whose ``entries`` (name, header address) are
    sorted by name: ``(size, build)`` where ``build(base)``
    returns the block's bytes laid out at ``base`` with the B-tree root's
    and the heap's addresses."""
    heap = bytearray(8)                      # offset 0: the empty name
    offsets = []
    for name, _ in entries:
        offsets.append(len(heap))
        heap += name + bytes(_pad8(len(name) + 1) - len(name))
    snods = [list(range(i, min(i + 2 * LEAF_K, len(entries))))
             for i in range(0, len(entries), 2 * LEAF_K)]
    # B-tree levels, leaves first: each node is a list of child indices into
    # the level below; the leaves' children are symbol-table nodes
    levels = [[list(range(i, min(i + 2 * NODE_K, len(snods))))
               for i in range(0, len(snods), 2 * NODE_K)] or [[]]]
    while len(levels[-1]) > 1:
        below = len(levels[-1])
        levels.append([list(range(i, min(i + 2 * NODE_K, below)))
                       for i in range(0, below, 2 * NODE_K)])
    n_nodes = sum(len(lv) for lv in levels)
    size = n_nodes * TREE_SIZE + len(snods) * SNOD_SIZE + HEAP_HEADER \
        + len(heap)

    def build(base: int):
        node_addr = []
        at = base
        for lv in levels:
            node_addr.append([at + i * TREE_SIZE for i in range(len(lv))])
            at += len(lv) * TREE_SIZE
        snod_at = at
        heap_at = snod_at + len(snods) * SNOD_SIZE
        # the largest name under each child, as heap offsets
        last = [offsets[s[-1]] for s in snods]
        out = bytearray()
        for depth, lv in enumerate(levels):
            child_addr = ([snod_at + i * SNOD_SIZE for i in range(len(snods))]
                          if depth == 0 else node_addr[depth - 1])
            last_up = []
            for j, kids in enumerate(lv):
                left = node_addr[depth][j - 1] if j else UNDEF
                right = (node_addr[depth][j + 1] if j + 1 < len(lv)
                         else UNDEF)
                key0 = last[kids[0] - 1] if kids and kids[0] else 0
                node = bytearray(struct.pack("<4sBBHQQ", b"TREE", 0, depth,
                                             len(kids), left, right))
                node += struct.pack("<Q", key0)
                for k in kids:
                    node += struct.pack("<QQ", child_addr[k], last[k])
                out += node + bytes(TREE_SIZE - len(node))
                if kids:
                    last_up.append(last[kids[-1]])
            last = last_up
        for s in snods:
            node = bytearray(struct.pack("<4sBxH", b"SNOD", 1, len(s)))
            for i in s:
                # groups carry no cached B-tree: readers open their header
                node += struct.pack("<QQI4x16x", offsets[i], entries[i][1], 0)
            out += node + bytes(SNOD_SIZE - len(node))
        out += struct.pack("<4sB3xQQQ", b"HEAP", 0, len(heap), FREE_NULL,
                           heap_at + HEAP_HEADER)
        out += heap
        return bytes(out), node_addr[-1][0], heap_at

    return size, build


class _Group:
    def __init__(self, path: str, header: int, depth: int):
        self.path = path
        self.header = header
        self.depth = depth
        self.children: dict[str, tuple[int, "_Group | None"]] = {}
        self.slots: list[list[int]] = []     # [address, capacity], two at most
        self.live = -1


class H5Writer:
    """Write an HDF5 file of groups and contiguous numeric datasets.

    ``create_dataset("Function/u/0", data=arr)`` creates the intermediate
    groups; ``flush()`` makes everything created so far part of the file on
    disk; ``close()`` flushes and closes.  The names and calls are h5py's, so
    code written against ``h5py.File(path, "w")`` needs no other change."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "w+b")
        self._eof = 96
        self._fh.write(bytes(96))
        self._groups: dict[str, _Group] = {}
        self._dirty: set[str] = set()
        self._root = self._new_group("", depth=0)
        self.flush()

    # ------------------------------------------------------------------ #
    def _append(self, data) -> int:
        addr = self._eof
        self._fh.seek(addr)
        self._fh.write(data)
        self._eof += _pad8(len(data))
        if self._eof > addr + len(data):
            self._fh.write(bytes(self._eof - addr - len(data)))
        return addr

    def _patch(self, addr: int, data: bytes):
        self._fh.seek(addr)
        self._fh.write(data)

    def _new_group(self, path: str, depth: int) -> _Group:
        grp = _Group(path, self._append(_group_header(UNDEF, UNDEF)), depth)
        self._groups[path] = grp
        self._dirty.add(path)
        return grp

    def _group(self, path: str) -> _Group:
        grp = self._root
        for part in [p for p in path.split("/") if p]:
            if part not in grp.children:
                sub = self._new_group(f"{grp.path}/{part}", grp.depth + 1)
                grp.children[part] = (sub.header, sub)
                self._dirty.add(grp.path)
            child = grp.children[part][1]
            if child is None:
                raise ValueError(f"{self.path}: {grp.path}/{part} is a "
                                 f"dataset, not a group")
            grp = child
        return grp

    # ------------------------------------------------------------------ #
    def create_dataset(self, name: str, data):
        """Write ``data`` (a numeric array of a supported dtype, stored
        little-endian) as the contiguous dataset ``name``."""
        arr = np.asarray(data)
        dt = arr.dtype.newbyteorder("<")
        if dt not in DTYPES:
            raise TypeError(f"{name}: dtype {arr.dtype} is not one of "
                            f"{', '.join(d.str for d in DTYPES)}")
        parent, _, leaf = name.strip("/").rpartition("/")
        grp = self._group(parent)
        if not leaf or leaf in grp.children:
            raise ValueError(f"{self.path}: cannot create {name!r}")
        raw = np.ascontiguousarray(arr, dtype=dt).tobytes()
        data_at = self._append(raw) if raw else UNDEF
        header = self._append(_dataset_header(arr.shape, dt, data_at,
                                              len(raw)))
        grp.children[leaf] = (header, None)
        self._dirty.add(grp.path)

    def flush(self):
        """Write the index of every changed group, then point the file at
        them: after this call the file on disk holds every dataset created
        so far."""
        groups = sorted((self._groups[p] for p in self._dirty),
                        key=lambda g: -g.depth)
        new = []
        for grp in groups:
            entries = sorted((name.encode(), addr)
                             for name, (addr, _) in grp.children.items())
            size, build = _group_index(entries)
            spare = 1 - grp.live if len(grp.slots) == 2 else len(grp.slots)
            if spare == len(grp.slots):
                grp.slots.append([0, 0])
            slot = grp.slots[spare]
            if slot[1] < size:
                slot[:] = [self._append(bytes(2 * size)), 2 * size]
            block, btree, heap = build(slot[0])
            self._patch(slot[0], block)
            new.append((grp, spare, (btree, heap)))
        self._patch(EOF_AT, struct.pack("<Q", self._eof))
        # children before parents: a group is reachable only once its own
        # index is in place
        for grp, spare, pointers in new:
            self._patch(grp.header + STAB_AT, struct.pack("<QQ", *pointers))
            if grp is self._root:
                self._write_superblock(*pointers)
            grp.live = spare
        self._dirty.clear()
        self._fh.flush()

    def _write_superblock(self, btree: int, heap: int):
        self._patch(0, SIGNATURE + struct.pack(
            "<8BHHI4Q", 0, 0, 0, 0, 0, 8, 8, 0, LEAF_K, NODE_K, 0,
            0, UNDEF, self._eof, UNDEF)
            + struct.pack("<QQI4xQQ", 0, self._root.header, 1, btree, heap))

    def close(self):
        if not self._fh.closed:
            self.flush()
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# --------------------------------------------------------------------------- #
# Reading
# --------------------------------------------------------------------------- #
class H5Reader:
    """Read groups and contiguous numeric datasets of an HDF5 file.

    ``read("Function/u/0")`` returns the dataset as a numpy array,
    ``keys("Function/u")`` the names in a group in the file's order (byte
    order of the names)."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        try:
            self._read_superblock()
        except BaseException:
            self._fh.close()
            raise
        self._listings: dict[int, dict[str, int]] = {}

    def _fail(self, what: str):
        raise HDF5FeatureError(f"{self.path}: {what} is outside the HDF5 "
                               f"subset this reader supports")

    def _read(self, addr: int, n: int) -> bytes:
        self._fh.seek(self._base + addr)
        buf = self._fh.read(n)
        if len(buf) != n:
            raise ValueError(f"{self.path}: truncated file (wanted {n} bytes "
                             f"at {addr})")
        return buf

    def _read_superblock(self):
        head = self._fh.read(24)
        if head[:8] != SIGNATURE:
            self._fail("a user block or a missing signature at offset 0")
        if head[8] != 0:
            self._fail(f"superblock version {head[8]}")
        if head[13] != 8 or head[14] != 8:
            self._fail(f"{head[13]}-byte addresses / {head[14]}-byte lengths")
        self._base, _, _, _ = struct.unpack("<4Q", self._fh.read(32))
        _, self._root = struct.unpack("<QQ", self._fh.read(16))

    def _messages(self, addr: int) -> list[tuple[int, int, bytes]]:
        head = self._read(addr, 16)
        if head[:4] == b"OHDR":
            self._fail("a version 2 object header")
        version, _, n, _, size = struct.unpack("<BBHII", head[:12])
        if version != 1:
            self._fail(f"object header version {version}")
        blocks = [(addr + 16, size)]
        out = []
        while blocks and len(out) < n:
            start, length = blocks.pop(0)
            buf = self._read(start, length)
            pos = 0
            while pos + 8 <= length and len(out) < n:
                mtype, msize, flags = struct.unpack_from("<HHB", buf, pos)
                body = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if flags & 0x2:
                    self._fail(f"a shared message (type {mtype:#06x})")
                if mtype == MSG_CONTINUATION:
                    blocks.append(struct.unpack("<QQ", body[:16]))
                out.append((mtype, flags, body))
        return out

    def _resolve(self, path: str) -> int:
        addr = self._root
        for part in [p for p in path.split("/") if p]:
            listing = self._listing(addr)
            if part not in listing:
                raise KeyError(f"{self.path}: no object {path!r}")
            addr = listing[part]
        return addr

    def _listing(self, addr: int) -> dict[str, int]:
        if addr in self._listings:
            return self._listings[addr]
        stab = None
        for mtype, _, body in self._messages(addr):
            if mtype in (MSG_LINK_INFO, MSG_LINK, MSG_GROUP_INFO):
                self._fail("link messages (a group with compact or dense "
                           "link storage)")
            if mtype == MSG_SYMBOL_TABLE:
                stab = struct.unpack("<QQ", body[:16])
        if stab is None:
            raise KeyError(f"{self.path}: object at {addr} is not a group")
        hsig, hver, dsize, _, daddr = struct.unpack(
            "<4sB3xQQQ", self._read(stab[1], HEAP_HEADER))
        if hsig != b"HEAP" or hver != 0:
            raise ValueError(f"{self.path}: bad local heap at {stab[1]}")
        heap = self._read(daddr, dsize)
        listing: dict[str, int] = {}

        def walk(node: int):
            sig, ntype, level, used = struct.unpack("<4sBBH",
                                                    self._read(node, 8))
            if sig != b"TREE" or ntype != 0:
                raise ValueError(f"{self.path}: bad group B-tree node at "
                                 f"{node}")
            body = self._read(node + 24, (2 * used + 1) * 8)
            for i in range(used):
                child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
                if level:
                    walk(child)
                    continue
                sig, ver, nsym = struct.unpack("<4sBxH", self._read(child, 8))
                if sig != b"SNOD" or ver != 1:
                    raise ValueError(f"{self.path}: bad symbol-table node "
                                     f"at {child}")
                ents = self._read(child + 8, nsym * ENTRY_SIZE)
                for j in range(nsym):
                    off, hdr = struct.unpack_from("<QQ", ents,
                                                  j * ENTRY_SIZE)
                    name = heap[off:heap.index(b"\0", off)].decode()
                    listing[name] = hdr

        walk(stab[0])
        self._listings[addr] = listing
        return listing

    # ------------------------------------------------------------------ #
    def keys(self, path: str = "/") -> list[str]:
        return list(self._listing(self._resolve(path)))

    def read(self, path: str) -> np.ndarray:
        shape = dtype = layout = None
        for mtype, _, body in self._messages(self._resolve(path)):
            if mtype == MSG_DATASPACE:
                shape = self._dataspace(body)
            elif mtype == MSG_DATATYPE:
                dtype = self._dtype(body)
            elif mtype == MSG_LAYOUT:
                layout = self._layout(body)
            elif mtype == MSG_FILTERS:
                self._fail("a filter pipeline (compression or another "
                           "filter)")
            elif mtype == MSG_EXTERNAL:
                self._fail("external data storage")
            elif mtype == MSG_SYMBOL_TABLE:
                raise KeyError(f"{self.path}: {path!r} is a group")
        if shape is None or dtype is None or layout is None:
            raise ValueError(f"{self.path}: {path!r} lacks a dataspace, "
                             f"datatype or layout message")
        count = int(np.prod(shape, dtype=np.int64))
        addr, nbytes = layout
        if count * dtype.itemsize > nbytes:
            raise ValueError(f"{self.path}: {path!r} stores {nbytes} bytes "
                             f"for {count} x {dtype}")
        if addr == UNDEF or count == 0:
            return np.zeros(shape, dtype)
        self._fh.seek(self._base + addr)
        arr = np.fromfile(self._fh, dtype=dtype, count=count)
        return arr.reshape(shape).astype(dtype.newbyteorder("="),
                                         copy=False)

    def _dataspace(self, body: bytes) -> tuple:
        if body[0] != 1:
            self._fail(f"dataspace message version {body[0]}")
        return struct.unpack_from(f"<{body[1]}Q", body, 8)

    def _dtype(self, body: bytes) -> np.dtype:
        cls, bits, size = body[0] & 0x0F, body[1], \
            struct.unpack_from("<I", body, 4)[0]
        if cls in TYPE_CLASSES:
            self._fail(f"the {TYPE_CLASSES[cls]} datatype class")
        if bits & 0x01:
            self._fail("a big-endian datatype")
        if cls == 0:
            offset, precision = struct.unpack_from("<HH", body, 8)
            if offset or precision != 8 * size or size not in (1, 2, 4, 8):
                self._fail(f"a {precision}-bit integer at bit offset "
                           f"{offset} in {size} bytes")
            return np.dtype(f"<{'i' if bits & 0x08 else 'u'}{size}")
        if bits & 0x40 or size not in IEEE:
            self._fail(f"a non-IEEE {size}-byte floating-point type")
        sign = body[2]
        offset, precision, eloc, esize, mloc, msize, bias = \
            struct.unpack_from("<HH4BI", body, 8)
        if (sign, eloc, esize, msize, bias) != IEEE[size] or offset or mloc:
            self._fail(f"a non-IEEE {size}-byte floating-point layout")
        return np.dtype(f"<f{size}")

    def _layout(self, body: bytes) -> tuple[int, int]:
        version, cls = body[0], body[1]
        if version != 3:
            self._fail(f"data layout message version {version}")
        if cls != 1:
            self._fail({0: "compact dataset layout",
                        2: "chunked dataset layout"}.get(
                            cls, f"dataset layout class {cls}"))
        return struct.unpack_from("<QQ", body, 2)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

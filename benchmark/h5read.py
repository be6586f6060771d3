"""Read back the HDF5 files the program's ``SaveFields`` writes.

A frozen copy of the reading half of safeincave_torch/output/hdf5.py
(``H5Reader``), cut to what those files use: superblock version 0, version
1 object headers, groups as symbol tables, contiguous little-endian numeric
datasets.  Anything else raises.
"""
from __future__ import annotations

import struct

import numpy as np

SIGNATURE = b"\x89HDF\r\n\x1a\n"
UNDEF = 0xFFFFFFFFFFFFFFFF
ENTRY_SIZE = 40
HEAP_HEADER = 32
MSG_DATASPACE, MSG_DATATYPE, MSG_LAYOUT = 0x1, 0x3, 0x8
MSG_CONTINUATION, MSG_SYMBOL_TABLE = 0x10, 0x11


class H5Reader:
    """``read("Function/u/0")`` -> numpy array; ``keys("Function/u")``."""

    def __init__(self, path: str):
        self.path = path
        self._fh = open(path, "rb")
        head = self._fh.read(24)
        if head[:8] != SIGNATURE or head[8] != 0 or head[13:15] != b"\x08\x08":
            self._fh.close()
            raise ValueError(f"{path}: not a version 0 HDF5 file")
        self._base = struct.unpack("<4Q", self._fh.read(32))[0]
        self._root = struct.unpack("<QQ", self._fh.read(16))[1]

    def _read(self, addr, n):
        self._fh.seek(self._base + addr)
        buf = self._fh.read(n)
        if len(buf) != n:
            raise ValueError(f"{self.path}: truncated at {addr}")
        return buf

    def _messages(self, addr):
        version, _, n, _, size = struct.unpack("<BBHII", self._read(addr, 12))
        if version != 1:
            raise ValueError(f"{self.path}: object header version {version}")
        blocks, out = [(addr + 16, size)], []
        while blocks and len(out) < n:
            start, length = blocks.pop(0)
            buf, pos = self._read(start, length), 0
            while pos + 8 <= length and len(out) < n:
                mtype, msize = struct.unpack_from("<HH", buf, pos)
                body = buf[pos + 8:pos + 8 + msize]
                pos += 8 + msize
                if mtype == MSG_CONTINUATION:
                    blocks.append(struct.unpack("<QQ", body[:16]))
                out.append((mtype, body))
        return out

    def _listing(self, addr):
        stab = next(struct.unpack("<QQ", b[:16]) for t, b in
                    self._messages(addr) if t == MSG_SYMBOL_TABLE)
        _, _, dsize, _, daddr = struct.unpack(
            "<4sB3xQQQ", self._read(stab[1], HEAP_HEADER))
        heap, listing = self._read(daddr, dsize), {}

        def walk(node):
            _, _, level, used = struct.unpack("<4sBBH", self._read(node, 8))
            body = self._read(node + 24, (2 * used + 1) * 8)
            for i in range(used):
                child = struct.unpack_from("<Q", body, 8 + 16 * i)[0]
                if level:
                    walk(child)
                    continue
                nsym = struct.unpack("<4sBxH", self._read(child, 8))[2]
                ents = self._read(child + 8, nsym * ENTRY_SIZE)
                for j in range(nsym):
                    off, hdr = struct.unpack_from("<QQ", ents, j * ENTRY_SIZE)
                    listing[heap[off:heap.index(b"\0", off)].decode()] = hdr

        walk(stab[0])
        return listing

    def _resolve(self, path):
        addr = self._root
        for part in [p for p in path.split("/") if p]:
            addr = self._listing(addr)[part]
        return addr

    def keys(self, path="/"):
        return list(self._listing(self._resolve(path)))

    def read(self, path):
        shape = dtype = layout = None
        for mtype, body in self._messages(self._resolve(path)):
            if mtype == MSG_DATASPACE:
                shape = struct.unpack_from(f"<{body[1]}Q", body, 8)
            elif mtype == MSG_DATATYPE:
                cls, bits = body[0] & 0x0F, body[1]
                size = struct.unpack_from("<I", body, 4)[0]
                kind = "f" if cls == 1 else ("i" if bits & 0x08 else "u")
                dtype = np.dtype(f"<{kind}{size}")
            elif mtype == MSG_LAYOUT:
                if body[0] != 3 or body[1] != 1:
                    raise ValueError(f"{self.path}: {path} is not contiguous")
                layout = struct.unpack_from("<QQ", body, 2)
        count = int(np.prod(shape, dtype=np.int64))
        if layout[0] == UNDEF or count == 0:
            return np.zeros(shape, dtype)
        self._fh.seek(self._base + layout[0])
        return np.fromfile(self._fh, dtype=dtype, count=count).reshape(shape)

    def close(self):
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

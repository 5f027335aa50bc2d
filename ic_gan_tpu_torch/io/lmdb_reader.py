"""Minimal pure-Python read-only LMDB reader (LSUN dataset ingestion): the
port's copy of ``ic_gan_tpu/io/lmdb_reader.py`` (numpy-free, torch-free).

The reference's ``dataset_tool.py:158-185`` iterates LSUN ``*_lmdb``
directories through the ``lmdb`` C extension, which is not available in
this environment (and is not needed: reading a committed LMDB file is a
straight b-tree walk over a memory-mapped file).  This module implements
just enough of the LMDB data format (upstream ``mdb.c`` layout, 64-bit
little-endian builds) to enumerate every ``(key, value)`` pair:

- meta pages 0/1: ``MDB_meta`` after the 16-byte page header — magic
  ``0xBEEFC0DE``, page size in ``mm_dbs[FREE_DBI].md_pad``, the main DB's
  root page / entry count in ``mm_dbs[MAIN_DBI]``; the live meta is the
  one with the larger ``mm_txnid``.
- branch/leaf pages: node-offset array after the header
  (``numkeys = (pb_lower - 16) >> 1``); 8-byte ``MDB_node`` headers with
  the child pgno (branch, bits 32-47 in ``mn_flags``) or the value size
  (leaf).
- ``F_BIGDATA`` leaf values (every LSUN image): an 8-byte overflow pgno
  after the key, data contiguous from the overflow page's header end.

Scope: read-only iteration of the main DB, no DUPSORT/LEAF2 sub-trees
(LSUN exports do not use them) — a named-DB or DUPSORT page raises.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Tuple

MDB_MAGIC = 0xBEEFC0DE

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

_PAGEHDR = 16  # pgno(8) + pad(2) + flags(2) + lower/upper or pages(4)


class LMDBReader:
    """Iterate ``(key, value)`` over the main DB of an LMDB file."""

    def __init__(self, path: str):
        # Accept either the environment directory or the data file itself.
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        self._f = open(path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        meta0 = self._read_meta(0, psize_guess=4096)
        # Page size lives in the meta itself; re-read page 1 with the real
        # size (meta pages are the first two pages of the file).
        self._psize = meta0["psize"]
        meta1 = self._read_meta(1, psize_guess=self._psize)
        meta = meta0 if meta0["txnid"] >= meta1["txnid"] else meta1
        self.entries = meta["entries"]
        self._root = meta["root"]
        if meta["flags"] & 0x04:  # MDB_DUPSORT main DB
            raise NotImplementedError("DUPSORT main DB not supported")

    def _read_meta(self, pageno: int, psize_guess: int) -> dict:
        off = pageno * psize_guess
        flags = struct.unpack_from("<H", self._mm, off + 10)[0]
        if not flags & P_META:
            raise ValueError(f"page {pageno} is not a meta page")
        m = off + _PAGEHDR
        magic, version = struct.unpack_from("<II", self._mm, m)
        if magic != MDB_MAGIC:
            raise ValueError("not an LMDB file (bad magic)")
        # MDB_meta: magic(4) version(4) address(8) mapsize(8) dbs[2] last_pg(8)
        # txnid(8); MDB_db: pad(4) flags(2) depth(2) branch(8) leaf(8)
        # overflow(8) entries(8) root(8) = 48 bytes.
        db0 = m + 24
        db1 = db0 + 48
        psize = struct.unpack_from("<I", self._mm, db0)[0]
        db_flags, _depth = struct.unpack_from("<HH", self._mm, db1 + 4)
        entries, root = struct.unpack_from("<qq", self._mm, db1 + 32)
        txnid = struct.unpack_from("<Q", self._mm, db1 + 48 + 8)[0]
        return {"psize": psize, "entries": entries, "root": root,
                "txnid": txnid, "flags": db_flags, "version": version}

    def _page(self, pgno: int) -> int:
        return pgno * self._psize

    def _walk(self, pgno: int) -> Iterator[Tuple[bytes, bytes]]:
        off = self._page(pgno)
        flags = struct.unpack_from("<H", self._mm, off + 10)[0]
        lower = struct.unpack_from("<H", self._mm, off + 12)[0]
        nkeys = (lower - _PAGEHDR) >> 1
        if flags & P_LEAF2:
            raise NotImplementedError("LEAF2 (DUPFIXED) pages not supported")
        ptrs = struct.unpack_from(f"<{nkeys}H", self._mm, off + _PAGEHDR)
        if flags & P_BRANCH:
            for p in ptrs:
                n = off + p
                lo, hi, nflags = struct.unpack_from("<HHH", self._mm, n)
                child = lo | (hi << 16) | (nflags << 32)
                yield from self._walk(child)
            return
        if not flags & P_LEAF:
            raise ValueError(f"unexpected page flags 0x{flags:x} @pg {pgno}")
        for p in ptrs:
            n = off + p
            lo, hi, nflags, ksize = struct.unpack_from("<HHHH", self._mm, n)
            key = bytes(self._mm[n + 8 : n + 8 + ksize])
            dsize = lo | (hi << 16)
            if nflags & (F_SUBDATA | F_DUPDATA):
                raise NotImplementedError("DUPSORT values not supported")
            if nflags & F_BIGDATA:
                (ovpg,) = struct.unpack_from("<Q", self._mm, n + 8 + ksize)
                d = self._page(ovpg) + _PAGEHDR
                value = bytes(self._mm[d : d + dsize])
            else:
                d = n + 8 + ksize
                value = bytes(self._mm[d : d + dsize])
            yield key, value

    def __iter__(self) -> Iterator[Tuple[bytes, bytes]]:
        if self._root < 0:  # empty DB (P_INVALID root)
            return
        yield from self._walk(self._root)

    def close(self):
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

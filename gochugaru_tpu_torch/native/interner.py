"""Native-backed string interner with the same surface as
``store.interner.Interner`` plus columnar batch entry points.

(type, object_id) pairs map to dense append-only int32 node ids — the
property that lets Watch-driven re-indexing patch device buffers instead
of rebuilding them (BASELINE config 5).  The hash table and string arena
live in C++ (native/ingest.cpp); this wrapper adds the type-name table
(Python: a handful of entries), thread-safety, and numpy-friendly batch
interning for the bulk Import path (client/client.go:438-465 is the
reference's equivalent ingestion surface).
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Sequence, Tuple

import numpy as np

from . import available, lib


class NativeInterner:
    """Drop-in for store.interner.Interner, backed by the C++ arena."""

    def __init__(self) -> None:
        self._lib = lib()
        if self._lib is None:
            raise RuntimeError("native ingest library unavailable")
        self._h = ctypes.c_void_p(self._lib.gi_new())
        self._lock = threading.Lock()
        self._types = {}
        self._type_names: List[str] = []

    def __del__(self) -> None:  # pragma: no cover - interpreter teardown
        try:
            if getattr(self, "_h", None) and self._lib is not None:
                self._lib.gi_free(self._h)
                self._h = None
        except Exception:
            pass

    # -- types (tiny; kept in Python) -----------------------------------
    def type_id(self, type_name: str) -> int:
        with self._lock:
            return self._type_id_locked(type_name)

    def _type_id_locked(self, type_name: str) -> int:
        tid = self._types.get(type_name)
        if tid is None:
            tid = len(self._type_names)
            self._types[type_name] = tid
            self._type_names.append(type_name)
        return tid

    def type_name(self, tid: int) -> str:
        return self._type_names[tid]

    def type_lookup(self, type_name: str) -> int:
        with self._lock:
            return self._types.get(type_name, -1)

    # -- batch plumbing --------------------------------------------------
    @staticmethod
    def _pack(ids: Sequence[str]) -> Tuple[bytes, np.ndarray]:
        # fast path: ONE join + ONE encode; when the result is pure
        # ASCII, character lengths equal byte lengths so the offsets
        # come from map(len) without per-string encodes (2M-id batches:
        # ~1.3s → ~0.3s).  Any non-ASCII id falls back to the exact
        # per-string form
        joined = "".join(ids)
        buf = joined.encode("utf-8")
        if len(buf) == len(joined):
            offsets = np.zeros(len(ids) + 1, np.int64)
            np.cumsum(np.fromiter(map(len, ids), np.int64, len(ids)),
                      out=offsets[1:])
            return buf, offsets
        bufs = [s.encode("utf-8") for s in ids]
        offsets = np.zeros(len(bufs) + 1, np.int64)
        np.cumsum([len(b) for b in bufs], out=offsets[1:])
        return b"".join(bufs), offsets

    def _batch(self, fn, type_ids: np.ndarray, ids: Sequence[str]) -> np.ndarray:
        buf, offsets = self._pack(ids)
        out = np.empty(len(ids), np.int32)
        fn(
            self._h, buf,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(len(ids)),
            np.ascontiguousarray(type_ids, np.int32).ctypes.data_as(
                ctypes.POINTER(ctypes.c_int32)
            ),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    # -- single-item surface (Interner parity) ---------------------------
    def node(self, type_name: str, object_id: str) -> int:
        with self._lock:
            tid = self._type_id_locked(type_name)
            return int(
                self._batch(self._lib.gi_intern_batch, np.array([tid]), [object_id])[0]
            )

    def lookup(self, type_name: str, object_id: str) -> int:
        with self._lock:
            tid = self._types.get(type_name)
            if tid is None:
                return -1
            return int(
                self._batch(self._lib.gi_lookup_batch, np.array([tid]), [object_id])[0]
            )

    def key_of(self, node: int) -> Tuple[str, str]:
        out_type = ctypes.c_int32(0)
        cap = 256
        while True:
            buf = ctypes.create_string_buffer(cap)
            n = self._lib.gi_key(
                self._h, ctypes.c_int64(node), buf, ctypes.c_int64(cap),
                ctypes.byref(out_type),
            )
            if n < 0:
                raise IndexError(f"unknown node {node}")
            if n <= cap:
                return self._type_names[out_type.value], buf.raw[:n].decode("utf-8")
            cap = int(n)

    def __len__(self) -> int:
        return int(self._lib.gi_size(self._h))

    def _keys_raw(self, nodes):
        """The shared native fetch behind both key-decode paths:
        (node array, raw id bytes, byte offsets list, type-id list).
        Under the lock: concurrent interning may reallocate the C++
        entry/arena vectors mid-copy (the Python Interner's lock-free
        read contract does not transfer to std::vector)."""
        nn = np.ascontiguousarray(nodes, np.int64)
        n = int(nn.shape[0])
        if n == 0:
            return nn, b"", [0], []
        offs = np.empty(n + 1, np.int64)
        types = np.empty(n, np.int32)
        cap = max(32 * n, 4096)
        with self._lock:
            while True:
                buf = ctypes.create_string_buffer(cap)
                total = int(self._lib.gi_keys_batch(
                    self._h,
                    nn.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    ctypes.c_int64(n), buf, ctypes.c_int64(cap),
                    offs.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                    types.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                ))
                if total <= cap:
                    break
                cap = total
        return nn, buf.raw, offs.tolist(), types.tolist()

    def keys_batch(self, nodes) -> List[Tuple[str, str]]:
        """(type, id) pairs for an int array of nodes in ONE native call
        (plus a retry when the id bytes outgrow the buffer guess) — the
        batched decode path behind snapshot exports."""
        nn, raw, o, tl = self._keys_raw(nodes)
        tn = self._type_names
        out = []
        for i in range(len(tl)):
            t = tl[i]
            if t < 0:  # C++ invalid-node sentinel — match key_of's raise
                raise IndexError(f"unknown node {int(nn[i])}")
            out.append((tn[t], raw[o[i] : o[i + 1]].decode("utf-8")))
        return out

    def keys_columns(self, nodes) -> Tuple[List[str], List[str]]:
        """(type_names, ids) as two parallel LISTS — the columnar decode
        path (snapshot exports): one whole-buffer utf-8 decode plus
        C-speed str slicing when the ids are ASCII, instead of a per-row
        bytes slice + decode + tuple."""
        nn, raw, o, tl = self._keys_raw(nodes)
        n = len(tl)
        if n == 0:
            return [], []
        if min(tl) < 0:
            # any negative type id is the invalid-node sentinel (mirror
            # keys_batch's t < 0 tolerance, not an exact -1 match)
            bad = next(i for i, t in enumerate(tl) if t < 0)
            raise IndexError(f"unknown node {int(nn[bad])}")
        text = raw[: o[n]].decode("utf-8")
        if len(text) == o[n]:  # pure ASCII: byte offsets == char offsets
            ids = [text[o[i] : o[i + 1]] for i in range(n)]
        else:
            ids = [raw[o[i] : o[i + 1]].decode("utf-8") for i in range(n)]
        tn = self._type_names
        return [tn[t] for t in tl], ids

    @property
    def num_types(self) -> int:
        return len(self._type_names)

    def node_type_array(self) -> np.ndarray:
        with self._lock:
            n = len(self)
            out = np.empty(max(n, 0), np.int32)
            if n:
                self._lib.gi_node_types(
                    self._h,
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                    ctypes.c_int64(n),
                )
            return out

    def node_type_tail(self, start: int) -> np.ndarray:
        """Type ids of nodes interned at or after ``start`` (see
        store/interner.py).  The C fill is one flat memcpy, so slicing
        it keeps no Python-loop constant."""
        return self.node_type_array()[start:]

    # -- columnar bulk entry points --------------------------------------
    def node_batch(self, type_name: str, ids: Sequence[str]) -> np.ndarray:
        """Intern many ids of one type; returns int32 node ids."""
        with self._lock:
            tid = self._type_id_locked(type_name)
            return self._batch(
                self._lib.gi_intern_batch,
                np.full(len(ids), tid, np.int32), ids,
            )

    def node_batch_typed(
        self, type_ids: np.ndarray, ids: Sequence[str]
    ) -> np.ndarray:
        """Intern many (interner-type-id, id) pairs at once."""
        with self._lock:
            return self._batch(self._lib.gi_intern_batch, type_ids, ids)

    def lookup_batch(self, type_name: str, ids: Sequence[str]) -> np.ndarray:
        with self._lock:
            tid = self._types.get(type_name)
            if tid is None:
                return np.full(len(ids), -1, np.int32)
            return self._batch(
                self._lib.gi_lookup_batch,
                np.full(len(ids), tid, np.int32), ids,
            )


def make_interner():
    """The framework's default interner: native when the C++ layer loads,
    pure-Python otherwise (identical semantics either way)."""
    if available():
        return NativeInterner()
    from ..store.interner import Interner

    return Interner()

"""String interning: (object_type, object_id) pairs → dense int32 node ids.

Node ids are append-only and stable across revisions, which is what lets
watch-driven incremental re-indexing (BASELINE config 5) patch device
buffers instead of rebuilding them.  Wildcard subjects (``user:*``) are
interned as ordinary nodes with id ``*`` so a wildcard grant is an exact
device-side key lookup.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np


class Interner:
    """Bidirectional (type, id) ↔ node-int mapping, thread-safe, append-only."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._node_of: Dict[Tuple[str, str], int] = {}
        self._types: Dict[str, int] = {}
        self._type_names: List[str] = []
        self._keys: List[Tuple[str, str]] = []
        self._node_type: List[int] = []

    # -- types -------------------------------------------------------------
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
        """Interner type id or -1, without interning.  NOTE: interner type
        ids are assigned in first-seen order and are NOT the schema
        compiler's type ids — always translate names through the right
        table."""
        with self._lock:
            return self._types.get(type_name, -1)

    # -- nodes -------------------------------------------------------------
    def node(self, type_name: str, object_id: str) -> int:
        """Intern (create if needed) and return the node id."""
        key = (type_name, object_id)
        with self._lock:
            n = self._node_of.get(key)
            if n is None:
                n = len(self._keys)
                self._node_of[key] = n
                self._keys.append(key)
                self._node_type.append(self._type_id_locked(type_name))
            return n

    def lookup(self, type_name: str, object_id: str) -> int:
        """Return the node id or -1 without interning (query path: an
        unknown object can never have permissions, so -1 flows through the
        engine as a guaranteed miss — checks on nonexistent resources return
        False, not an error, client/client_test.go:209-215)."""
        return self._node_of.get((type_name, object_id), -1)

    def key_of(self, node: int) -> Tuple[str, str]:
        return self._keys[node]

    def keys_batch(self, nodes) -> List[Tuple[str, str]]:
        """(type, id) pairs for an int array of nodes — the batched
        decode path (snapshot exports).  Reads race-safely without the
        lock: the list is append-only and CPython appends are atomic."""
        k = self._keys
        return [k[n] for n in np.asarray(nodes).tolist()]

    def __len__(self) -> int:
        return len(self._keys)

    @property
    def num_types(self) -> int:
        return len(self._type_names)

    def node_type_array(self) -> np.ndarray:
        """int32[num_nodes] type id per node (snapshot-time copy)."""
        with self._lock:
            return np.asarray(self._node_type, dtype=np.int32)

    def node_type_tail(self, start: int) -> np.ndarray:
        """Type ids of nodes interned at or after ``start`` — lets the
        O(delta) snapshot path extend a base node_type array without
        copying the full list (store/delta.py LsmSnapshot)."""
        with self._lock:
            return np.asarray(self._node_type[start:], dtype=np.int32)

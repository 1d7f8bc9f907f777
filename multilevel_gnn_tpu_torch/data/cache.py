"""Content-addressed preprocessing cache (port of
multilevel_gnn_tpu/data/cache.py, byte-compatible with it).

Entries are pickles under root/<key>.pkl, the key the first 32 hex digits
of a sha256 over the repr of each part in turn, so the same parts give the
JAX package's key and either package's entries serve the other.
"""
from __future__ import annotations

import hashlib
import os
import pickle
from typing import Any, Optional


def content_key(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(repr(p).encode())
    return h.hexdigest()[:32]


class PreprocessCache:
    def __init__(self, root: str = "./data_cache"):
        self.root = root
        os.makedirs(root, exist_ok=True)

    def _path(self, key: str) -> str:
        return os.path.join(self.root, key + ".pkl")

    def get(self, key: str) -> Optional[Any]:
        p = self._path(key)
        if os.path.exists(p):
            with open(p, "rb") as f:
                return pickle.load(f)
        return None

    def put(self, key: str, value: Any) -> None:
        tmp = self._path(key) + ".tmp"
        with open(tmp, "wb") as f:
            pickle.dump(value, f)
        os.replace(tmp, self._path(key))

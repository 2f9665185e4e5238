"""Stats storage API + implementations (port of
``deeplearning4j_tpu/ui/storage.py``; host-side, stdlib only).

Reference: deeplearning4j-core api/storage/ (StatsStorageRouter — write side,
StatsStorage.java:30 — read/query side, Persistable), ui-model storage impls
(InMemoryStatsStorage.java:21, FileStatsStorage.java:15 — MapDB there, a
JSON-lines file here; no native storage engine required).

A record is a plain dict with routing keys session_id / type_id / worker_id /
timestamp plus a free-form ``data`` payload — the JSON-able stand-in for the
reference's SBE-encoded Persistable.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Optional


def make_record(session_id: str, type_id: str, worker_id: str, data: dict,
                timestamp: Optional[float] = None) -> dict:
    return {"session_id": session_id, "type_id": type_id,
            "worker_id": worker_id,
            "timestamp": time.time() if timestamp is None else timestamp,
            "data": data}


class StatsStorageRouter:
    """Write-side contract (reference: api/storage/StatsStorageRouter.java)."""

    def put_static_info(self, record: dict) -> None:
        raise NotImplementedError

    def put_update(self, record: dict) -> None:
        raise NotImplementedError

    def put_storage_metadata(self, record: dict) -> None:
        raise NotImplementedError


class StatsStorage(StatsStorageRouter):
    """Read/query side + listeners (reference: api/storage/StatsStorage.java:30
    — listSessionIDs, getAllUpdatesAfter, getStaticInfo, registerListener)."""

    def __init__(self):
        self._static: list = []
        self._updates: list = []
        self._meta: list = []
        self._listeners: list = []
        self._lock = threading.Lock()

    # ---- write side
    def put_static_info(self, record: dict) -> None:
        with self._lock:
            self._static.append(record)
        self._notify("static", record)

    def put_update(self, record: dict) -> None:
        with self._lock:
            self._updates.append(record)
        self._notify("update", record)

    def put_storage_metadata(self, record: dict) -> None:
        with self._lock:
            self._meta.append(record)
        self._notify("meta", record)

    def _notify(self, kind: str, record: dict) -> None:
        for cb in list(self._listeners):
            cb(kind, record)

    # ---- read side
    def list_session_ids(self) -> list:
        with self._lock:
            return sorted({r["session_id"]
                           for r in self._static + self._updates})

    def list_type_ids(self, session_id: str) -> list:
        with self._lock:
            return sorted({r["type_id"] for r in self._updates
                           if r["session_id"] == session_id})

    def list_worker_ids(self, session_id: str) -> list:
        with self._lock:
            return sorted({r["worker_id"] for r in self._updates
                           if r["session_id"] == session_id})

    def get_static_info(self, session_id: str, type_id: str,
                        worker_id: Optional[str] = None) -> Optional[dict]:
        with self._lock:
            for r in reversed(self._static):
                if (r["session_id"] == session_id
                        and r["type_id"] == type_id
                        and (worker_id is None
                             or r["worker_id"] == worker_id)):
                    return r
        return None

    def get_all_updates_after(self, session_id: str, type_id: str,
                              timestamp: float = 0.0) -> list:
        with self._lock:
            return [r for r in self._updates
                    if r["session_id"] == session_id
                    and r["type_id"] == type_id
                    and r["timestamp"] > timestamp]

    def get_latest_update(self, session_id: str, type_id: str
                          ) -> Optional[dict]:
        upd = self.get_all_updates_after(session_id, type_id)
        return upd[-1] if upd else None

    def num_updates(self) -> int:
        with self._lock:
            return len(self._updates)

    def register_stats_storage_listener(
            self, cb: Callable[[str, dict], None]) -> None:
        self._listeners.append(cb)

    def deregister_stats_storage_listener(self, cb) -> None:
        if cb in self._listeners:
            self._listeners.remove(cb)

    def close(self) -> None:
        pass


class InMemoryStatsStorage(StatsStorage):
    """reference: ui/storage/InMemoryStatsStorage.java:21 — StatsStorage's
    in-process lists ARE the store."""


class FileStatsStorage(StatsStorage):
    """JSON-lines file persistence (reference: ui/storage/FileStatsStorage.java
    :15, MapDB-backed there). Appends on write; reloads on open."""

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        if os.path.exists(path):
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    kind, record = json.loads(line)
                    {"static": self._static, "update": self._updates,
                     "meta": self._meta}[kind].append(record)
        self._f = open(path, "a", encoding="utf-8")

    def _append(self, kind: str, record: dict) -> None:
        self._f.write(json.dumps([kind, record]) + "\n")
        self._f.flush()

    def put_static_info(self, record: dict) -> None:
        super().put_static_info(record)
        self._append("static", record)

    def put_update(self, record: dict) -> None:
        super().put_update(record)
        self._append("update", record)

    def put_storage_metadata(self, record: dict) -> None:
        super().put_storage_metadata(record)
        self._append("meta", record)

    def close(self) -> None:
        self._f.close()

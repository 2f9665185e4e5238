"""Remote stats routing over HTTP (port of
``deeplearning4j_tpu/ui/remote.py``).

Reference: api/storage/impl/RemoteUIStatsStorageRouter.java:33 — POSTs
serialized records to a UI server's /remoteReceive endpoint, with retry
backoff. Wire format here is JSON: {"kind": static|update|meta, "record":
{...}} — received by UIServer's RemoteReceiverModule equivalent.
"""

from __future__ import annotations

import json
import logging
import time
import urllib.request

log = logging.getLogger(__name__)


class RemoteUIStatsStorageRouter:
    def __init__(self, address: str, path: str = "/remoteReceive",
                 max_retries: int = 3, retry_backoff: float = 0.5,
                 timeout: float = 5.0):
        self.url = address.rstrip("/") + path
        self.max_retries = max_retries
        self.retry_backoff = retry_backoff
        self.timeout = timeout

    def _post(self, kind: str, record: dict) -> bool:
        body = json.dumps({"kind": kind, "record": record}).encode()
        req = urllib.request.Request(
            self.url, data=body, headers={"Content-Type": "application/json"},
            method="POST")
        for attempt in range(self.max_retries):
            try:
                with urllib.request.urlopen(req, timeout=self.timeout) as r:
                    return 200 <= r.status < 300
            except Exception as e:  # noqa: BLE001 — network path
                log.warning("remote stats post failed (%d/%d): %s",
                            attempt + 1, self.max_retries, e)
                time.sleep(self.retry_backoff * (2 ** attempt))
        return False

    def put_static_info(self, record: dict) -> None:
        self._post("static", record)

    def put_update(self, record: dict) -> None:
        self._post("update", record)

    def put_storage_metadata(self, record: dict) -> None:
        self._post("meta", record)

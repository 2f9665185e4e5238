"""Rolling checkpoints for long training runs (port of ``CheckpointStore``
and ``CheckpointListener`` from ``deeplearning4j_tpu/parallel/elastic.py``):
the store the health guard's rollback rung restores from.

Checkpoints are the model zip (``utils/model_serializer.py``), so either
package loads them. ``FaultTolerantTrainer``, the heartbeats and the fault
injection of the JAX module are ROADMAP A11c.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings
import zipfile
from typing import Callable, Optional

from deeplearning4j_torch.optimize.listeners import TrainingListener
from deeplearning4j_torch.utils.model_serializer import load_model, save_model

_META_NAME = "elastic.json"


class CheckpointStore:
    """Rolling crash-consistent checkpoint directory.

    Writes are atomic (a temporary file in the same directory, then
    ``os.replace``), so a crash mid-save never destroys the previous good
    checkpoint. On read every candidate is CRC-checked (``ZipFile.testzip``)
    before it is trusted; an invalid file is renamed ``*.corrupt`` and
    skipped. A quantized net cannot be saved (``save_model`` refuses its
    int8 tree), so a store never holds one.
    """

    TMP_SWEEP_AGE_S = 600  # an orphan .tmp older than this is crash debris

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        # sweep stale temp files of saves killed before their rename; "now"
        # is the filesystem's own clock (a fresh probe file's mtime)
        fd, probe = tempfile.mkstemp(suffix=".probe", dir=directory)
        try:
            os.close(fd)
            now = os.path.getmtime(probe)
        finally:
            os.unlink(probe)
        for name in os.listdir(directory):
            if name.endswith(".tmp"):
                path = os.path.join(directory, name)
                try:
                    if now - os.path.getmtime(path) > self.TMP_SWEEP_AGE_S:
                        os.unlink(path)
                except OSError:
                    pass

    def _path(self, iteration: int) -> str:
        return os.path.join(self.directory, f"ckpt-{iteration:010d}.zip")

    def checkpoints(self) -> list:
        """Valid checkpoint paths, oldest first."""
        out = []
        for name in sorted(os.listdir(self.directory)):
            if name.startswith("ckpt-") and name.endswith(".zip"):
                path = os.path.join(self.directory, name)
                if self._valid(path):
                    out.append(path)
        return out

    def _valid(self, path: str) -> bool:
        try:
            with zipfile.ZipFile(path) as zf:
                if zf.testzip() is not None:
                    raise zipfile.BadZipFile("CRC mismatch")
                names = zf.namelist()
                if "configuration.json" not in names or \
                        "coefficients.bin" not in names:
                    raise zipfile.BadZipFile("missing entries")
            return True
        except zipfile.BadZipFile as e:
            warnings.warn(f"quarantining corrupt checkpoint {path}: {e}")
            try:
                os.replace(path, path + ".corrupt")
            except OSError:
                pass
            return False
        except OSError as e:
            # a transient read failure is not evidence of corruption
            warnings.warn(f"skipping unreadable checkpoint {path} "
                          f"(transient?): {e}")
            return False

    def save(self, net, extra_meta: Optional[dict] = None) -> str:
        path = self._path(net.iteration)
        fd, tmp = tempfile.mkstemp(dir=self.directory, suffix=".tmp")
        os.close(fd)
        try:
            save_model(net, tmp)
            if extra_meta:
                with zipfile.ZipFile(tmp, "a") as zf:
                    zf.writestr(_META_NAME, json.dumps(extra_meta))
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        self._prune()
        return path

    def _prune(self) -> None:
        ckpts = [p for p in sorted(os.listdir(self.directory))
                 if p.startswith("ckpt-") and p.endswith(".zip")]
        for name in ckpts[:-self.keep] if self.keep > 0 else []:
            try:
                os.unlink(os.path.join(self.directory, name))
            except OSError:
                pass

    def latest(self) -> Optional[str]:
        ckpts = self.checkpoints()
        return ckpts[-1] if ckpts else None

    def restore(self, device=None):
        """(net, extra_meta) from the newest valid checkpoint, loaded on
        ``device`` (CUDA unless the caller names another), or None. Falls
        back to the next older checkpoint when a load fails; raises when
        every checkpoint that validated fails to load."""
        skip = set()
        while True:
            candidates = [p for p in self.checkpoints() if p not in skip]
            if not candidates:
                if skip:
                    raise RuntimeError(
                        "all checkpoints failed to load after validating "
                        f"({sorted(skip)}); refusing to silently restart "
                        "from scratch; inspect or remove them to proceed")
                return None
            path = candidates[-1]
            try:
                net = load_model(path, device=device)
                meta = {}
                with zipfile.ZipFile(path) as zf:
                    if _META_NAME in zf.namelist():
                        meta = json.loads(zf.read(_META_NAME).decode())
                return net, meta
            except (OSError, zipfile.BadZipFile, KeyError) as e:
                warnings.warn(f"checkpoint {path} vanished/unreadable "
                              f"during restore ({e}); trying next-older")
                skip.add(path)


class CheckpointListener(TrainingListener):
    """Checkpoint every ``frequency`` iterations through the listener hook.

    ``health_gated`` (default True): under an active health guard
    (``optimize/health.py``), a save opportunity inside an unhealthy
    window (skipped steps since the last save) is passed over, so the
    newest checkpoint stays a last-known-good. No guard, no gating."""

    def __init__(self, store: CheckpointStore, frequency: int = 100,
                 meta_fn: Optional[Callable[[], dict]] = None,
                 health_gated: bool = True):
        self.store = store
        self.frequency = frequency
        self.meta_fn = meta_fn
        self.health_gated = health_gated
        self.saved = 0
        self.skipped_unhealthy = 0

    def iteration_done(self, model, iteration: int):
        if iteration % self.frequency != 0:
            return
        if self.health_gated:
            health = getattr(model, "_health", None)
            if health is not None and not health.healthy_to_save():
                self.skipped_unhealthy += 1
                return
        self.store.save(model, self.meta_fn() if self.meta_fn else None)
        self.saved += 1

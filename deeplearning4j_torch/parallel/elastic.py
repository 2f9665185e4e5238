"""Failure detection and elastic recovery for long training runs (port of
``deeplearning4j_tpu/parallel/elastic.py``):

- ``CheckpointStore``: crash-consistent rolling checkpoints (atomic rename;
  corrupt or truncated files found by CRC and quarantined), the store the
  health guard's rollback rung restores from;
- ``CheckpointListener``: a save every N iterations through the listener
  hook;
- ``FaultTolerantTrainer``: an epoch-aware loop that records the exact
  mid-epoch position and, on restart, fast-forwards to the first batch not
  yet trained; ``run()`` resumes if it can, else starts;
- ``Heartbeat`` / ``FailureDetector``: a liveness file per worker process
  and a stall detector that ages it on the observer's monotonic clock;
- ``FaultInjectionListener``: a deterministic crash for recovery tests.

Checkpoints are the model zip (``utils/model_serializer.py``), so either
package loads them; a restore lands on the device the caller names (the
trainer's: its net's).
"""

from __future__ import annotations

import json
import os
import tempfile
import threading
import time
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


class FaultTolerantTrainer:
    """Elastic training loop: checkpoint every N iterations, resume from
    the last good checkpoint after any crash, a process kill included,
    without training a completed batch twice.

    ``iterator_factory`` returns a fresh (or reset-able) iterator for an
    epoch each time it is called; that the stream comes in the same order
    every time is the caller's contract.
    """

    def __init__(self, net, store: CheckpointStore, frequency: int = 50):
        self.net = net
        self.store = store
        self.frequency = frequency
        self._batch_in_epoch = 0
        # net.iteration on entering the batch in flight, None between
        # batches: tells the emergency save a crash after the update (a
        # listener raising post-step) from one before it
        self._iter_at_batch_start: Optional[int] = None

    def _meta(self) -> dict:
        return {"epoch": self.net.epoch,
                "batch_in_epoch": self._batch_in_epoch}

    def fit(self, iterator_factory: Callable[[], object], epochs: int,
            start_epoch: int = 0, skip_batches: int = 0):
        try:
            return self._fit_loop(iterator_factory, epochs, start_epoch,
                                  skip_batches)
        except BaseException as exc:
            # a best-effort checkpoint at the crash point, so a restart
            # resumes from here instead of the last periodic save
            self._emergency_save(exc)
            raise

    def _fit_loop(self, iterator_factory, epochs, start_epoch, skip_batches):
        net = self.net
        for epoch in range(start_epoch, epochs):
            net.epoch = epoch
            for listener in net.listeners:
                listener.on_epoch_start(net)
            it = iterator_factory()
            if hasattr(it, "reset"):
                it.reset()
            self._batch_in_epoch = 0
            for ds in it:
                if skip_batches > 0:
                    skip_batches -= 1
                    self._batch_in_epoch += 1
                    continue
                self._iter_at_batch_start = net.iteration
                net._fit_batch(ds)
                self._iter_at_batch_start = None
                self._batch_in_epoch += 1
                if net.iteration % self.frequency == 0:
                    self.store.save(net, self._meta())
            if skip_batches > 0:
                # the resumed stream is shorter than when the checkpoint was
                # written (the factory broke its contract): without this the
                # leftover skips would swallow the next epoch's first batches
                warnings.warn(
                    f"resume skip position exceeded epoch {epoch} length by "
                    f"{skip_batches} batches: the iterator_factory is not "
                    "producing the same stream it did when the checkpoint "
                    "was written; dropping the leftover skips")
                skip_batches = 0
            for listener in net.listeners:
                listener.on_epoch_end(net)
        net.epoch = epochs
        self.store.save(net, {"epoch": epochs, "batch_in_epoch": 0,
                              "complete": True})
        return net

    def _emergency_save(self, exc) -> None:
        """Crash checkpoint, guarded so that a second failure (a full disk,
        a net in a broken state) never masks the original exception."""
        try:
            net = self.net
            batch = self._batch_in_epoch
            if (self._iter_at_batch_start is not None
                    and net.iteration > self._iter_at_batch_start):
                # the batch in flight was applied before the raise, but the
                # position had not advanced yet: count it as trained
                batch += 1
            self.store.save(net, {"epoch": net.epoch,
                                  "batch_in_epoch": batch,
                                  "emergency": True,
                                  "error": repr(exc)})
        except BaseException as save_exc:  # noqa: BLE001 (must not mask exc)
            try:
                warnings.warn(
                    f"emergency checkpoint failed ({save_exc!r}); resuming "
                    "will fall back to the last periodic checkpoint")
            except BaseException:
                pass

    def run(self, iterator_factory: Callable[[], object], epochs: int):
        """Resume from the newest checkpoint if there is one, else start.
        Returns the trained network (which replaces ``self.net`` on a
        resume; the restored net lands on ``self.net``'s device).

        This trainer's checkpoints carry the exact (epoch, batch_in_epoch)
        position. A checkpoint without it (a bare ``CheckpointListener``'s)
        resumes at the position derived from the restored iteration count
        and the stream length (one counting pass over a fresh iterator)."""
        restored = self.store.restore(device=getattr(self.net, "device",
                                                     None))
        if restored is None:
            return self.fit(iterator_factory, epochs)
        net, meta = restored
        if meta.get("complete"):
            self.net = net
            return net
        if "epoch" in meta and "batch_in_epoch" in meta:
            start_epoch = meta["epoch"]
            skip = meta["batch_in_epoch"]
        else:
            per_epoch = sum(1 for _ in iterator_factory())
            if per_epoch == 0:
                raise ValueError("iterator_factory produced an empty stream")
            start_epoch = net.iteration // per_epoch
            skip = net.iteration % per_epoch
            warnings.warn(
                "checkpoint has no elastic position metadata; derived "
                f"resume point epoch={start_epoch} batch={skip} from "
                f"iteration={net.iteration} and stream length {per_epoch}")
        net.listeners = self.net.listeners
        self.net = net
        return self.fit(iterator_factory, epochs,
                        start_epoch=start_epoch, skip_batches=skip)


class Heartbeat:
    """Periodic liveness file of one worker process.

    A daemon thread rewrites ``{pid, ts}`` every ``interval`` seconds
    (a temporary file, then ``os.replace``); observers call
    ``FailureDetector.dead_workers`` to find workers whose file stopped
    changing. A worker wedged inside a device step stops beating though
    its process lives."""

    #: consecutive failed beats before the loop warns
    WARN_AFTER_FAILURES = 5

    def __init__(self, path: str, interval: float = 1.0):
        self.path = path
        self.interval = interval
        self.consecutive_failures = 0
        self._warned = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat(self) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"pid": os.getpid(), "ts": time.time()}, fh)
        os.replace(tmp, self.path)

    def start(self) -> "Heartbeat":
        self.beat()   # the first beat fails fast on an unwritable path
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def _loop(self) -> None:
        # a transient OSError (a full disk, an NFS blip) must not end the
        # loop: a dead heartbeat thread reads as a dead worker to every
        # observer. Keep beating; the next success clears the streak.
        while not self._stop.wait(self.interval):
            try:
                self.beat()
                self.consecutive_failures = 0
                self._warned = False
            except OSError as e:
                self.consecutive_failures += 1
                if (self.consecutive_failures >= self.WARN_AFTER_FAILURES
                        and not self._warned):
                    self._warned = True
                    warnings.warn(
                        f"heartbeat {self.path} failed "
                        f"{self.consecutive_failures} consecutive times "
                        f"({e!r}); still retrying")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    def __enter__(self) -> "Heartbeat":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


class FailureDetector:
    """Scan a directory of heartbeat files for stalled or dead workers.

    Staleness is detected as no change on the observer's monotonic clock:
    the persisted wall-clock ``ts`` is a version number, and a worker is
    dead once its ``ts`` has not moved for ``timeout`` seconds of observer
    time. Comparing the writer's wall clock with the observer's would
    declare every worker dead the moment either clock steps."""

    def __init__(self, directory: str, timeout: float = 10.0):
        self.directory = directory
        self.timeout = timeout
        # worker -> (last persisted ts seen, observer-monotonic instant it
        # was first seen)
        self._observed: dict = {}

    def workers(self) -> dict:
        out = {}
        if not os.path.isdir(self.directory):
            return out
        for name in os.listdir(self.directory):
            if not name.endswith(".heartbeat"):
                continue
            try:
                with open(os.path.join(self.directory, name)) as fh:
                    out[name[:-len(".heartbeat")]] = json.load(fh)
            except (OSError, json.JSONDecodeError):
                out[name[:-len(".heartbeat")]] = None
        return out

    def dead_workers(self, now: Optional[float] = None,
                     timeout: Optional[float] = None) -> list:
        """Workers whose heartbeat has not advanced for ``timeout``
        observer-seconds (or whose file is unreadable). ``now`` stands in
        for the observer's ``time.monotonic()`` (a test hook); ``timeout``
        overrides the constructor's for this call, so one detector answers
        a short suspect question and a long dead question off one
        observation table."""
        mono = time.monotonic() if now is None else now
        stale_after = self.timeout if timeout is None else timeout
        seen = self.workers()
        # forget workers whose file vanished: a re-created one starts a
        # fresh staleness window
        self._observed = {w: v for w, v in self._observed.items()
                          if w in seen}
        dead = []
        for worker, info in seen.items():
            if info is None:
                dead.append(worker)
                continue
            ts = info.get("ts", 0)
            prev = self._observed.get(worker)
            if prev is None or prev[0] != ts:
                # first sight, or the ts moved since the last scan
                self._observed[worker] = (ts, mono)
            elif mono - prev[1] > stale_after:
                dead.append(worker)
        return sorted(dead)


class FaultInjectionListener(TrainingListener):
    """Raise at a chosen iteration: deterministic crash injection for
    recovery tests."""

    class InjectedFault(RuntimeError):
        pass

    def __init__(self, at_iteration: int):
        self.at_iteration = at_iteration

    def iteration_done(self, model, iteration: int):
        if iteration == self.at_iteration:
            raise self.InjectedFault(f"injected fault at {iteration}")

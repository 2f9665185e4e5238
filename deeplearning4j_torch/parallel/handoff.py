"""KV-page snapshot/restore: the wire format of a live generation request
(port of ``deeplearning4j_tpu/parallel/handoff.py``, numpy only).

A live request's restartable state is host mirrors plus device KV pages:
the prompt, the accepted-token history, the stream position, and the
sampling parameters. The sampling key schedule is server-state-free
(``fold_in(PRNGKey(seed), token_index)``), so that state resumes the
request anywhere and reproduces the rest of the completion bit for bit.

- ``KVSnapshot``: a versioned, checksummed serialization of one live slot:
  resident KV pages stacked per attention layer (int8 pages ship with their
  scale planes), the logical page list with the prefix-cache chunk digests
  attached, and the resume header (prompt, emitted tokens, position,
  fold-in count, sampling parameters). ``to_bytes()``/``from_bytes()``
  round-trip it through a flat byte string; ``verify()`` recomputes the
  sha256 over the content so a corrupted snapshot is refused before any
  page lands in a pool.
- ``export_request(server, future)`` / ``adopt_request(server, snap)``:
  module-level verbs over ``GenerationServer.export_request`` /
  ``GenerationServer.adopt_request``.

The bytes are the contract between the two packages: this module is a copy
of the JAX package's, so a snapshot either package writes is read by the
other byte for byte (``tests/test_torch_handoff.py``). Wire v3's payload
is the canonical host layout (full ``[n, H, ps, d]`` stacks), which is what
the port's single-device server holds.

Snapshots are model-blind: adopting one into a server whose net holds
different weights resumes consistently but meaninglessly (the KV pages
encode the exporter's weights).
"""

from __future__ import annotations

import hashlib
import json
import struct
from typing import Dict, List, Optional

import numpy as np

from deeplearning4j_torch.parallel.resilience import ResilienceError

#: KVSnapshot wire-format version. Bump on any layout change. Unknown
#: versions are refused typed ``SnapshotInvalid``; KNOWN-but-different
#: versions (a v3 snapshot at a v2-geometry reader, or vice versa) are
#: refused typed ``SnapshotUnsupported`` with the full geometry tuple in
#: the message — never a checksum error, never a silent truncation.
#: v2: ``deadline_remaining`` joined the resume header — the request's
#: remaining Deadline budget in seconds (never an absolute timestamp, so
#: the field survives wall-clock skew between exporter and adopter).
#: v3: mesh-aware page geometry — ``shards`` (the exporter's
#: tensor-parallel degree) and ``head_layout`` joined the header. The
#: page payload is ALWAYS the canonical host layout (full
#: ``[NP, H, ps, d]`` stacks — export gathers the head shards back
#: together), so any-tp adopters re-shard locally and a tp=2 exporter
#: hands off to a tp=4 or tp=1 adopter without a re-pack.
WIRE_VERSION = 3

#: the one payload layout v3 speaks: full head axis, page-major. Kept as
#: a named constant so a future device-native layout bumps the wire
#: version instead of silently reinterpreting bytes.
CANONICAL_HEAD_LAYOUT = "canonical"

_MAGIC = b"KVSN"

#: bf16 page leaves as the port holds them in a payload: numpy has no bf16
#: of its own, so the raw 16-bit words ride as uint16 under this dtype,
#: whose metadata names them "bfloat16" in the header, the name the JAX
#: package's arrays carry. The bytes on the wire are the same.
BF16_WIRE = np.dtype(np.uint16, metadata={"wire": "bfloat16"})


class SnapshotError(ResilienceError):
    """Base of the handoff failure taxonomy. Every snapshot/adopt
    failure is typed so the fleet can fall back to token-0 regeneration
    instead of losing the request."""


class SnapshotInvalid(SnapshotError):
    """The snapshot failed checksum or version validation — corrupted
    in transit or produced by an incompatible writer. Never adopted;
    the caller regenerates from token 0."""


class SnapshotUnsupported(SnapshotError):
    """The snapshot cannot be hosted by this server (kv_dtype/page
    geometry mismatch, or a speculative-decoding server on either
    end — the draft's dense cache is not part of the wire format)."""


class SnapshotUnavailable(SnapshotError):
    """No snapshot could be taken: the request is not (or no longer)
    resident in a decode slot."""


class RequestMigrated(ResilienceError):
    """The request was exported off a draining server mid-stream. The
    snapshot rides on the failed future (``_kv_snapshot``); a fleet
    parks the request and resumes it on another replica. HTTP mapping:
    503 (when it escapes a bare server with no fleet above it)."""


def _wire_name(a: np.ndarray) -> str:
    """The header's dtype name for a payload leaf."""
    return (a.dtype.metadata or {}).get("wire", str(a.dtype))


def _wire_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a header's leaf of dtype ``name``."""
    if name == "bfloat16":
        return BF16_WIRE
    try:
        return np.dtype(name)
    except TypeError:
        raise SnapshotUnsupported(
            f"KV page leaves of dtype {name!r} cannot be read") from None


def _leaf_items(payload: Dict[str, Dict[str, np.ndarray]]):
    """Deterministic (vertex, leaf, array) iteration order — the
    checksum and the byte layout both depend on it."""
    for vn in sorted(payload):
        for leaf in sorted(payload[vn]):
            yield vn, leaf, payload[vn][leaf]


class KVSnapshot:
    """One live generation request, serialized. Header fields are plain
    Python scalars; ``payload`` stacks the resident pages per attention
    vertex as ``{vertex: {leaf: [n_pages, ...] array}}`` (int8 pools
    carry ``kscales``/``vscales`` planes alongside ``kpages``/
    ``vpages``); ``page_digests[i]`` is the prefix-cache chunk digest of
    logical page ``i`` when the exporter had it registered, else None.
    """

    __slots__ = ("version", "prompt", "tokens", "pos", "count", "last",
                 "key", "temperature", "top_k", "seed", "eos_id",
                 "max_tokens", "kv_dtype", "page_size",
                 "page_token_bytes", "page_digests", "payload",
                 "deadline_remaining", "shards", "head_layout",
                 "checksum")

    def __init__(self, *, version, prompt, tokens, pos, count, last, key,
                 temperature, top_k, seed, eos_id, max_tokens, kv_dtype,
                 page_size, page_token_bytes, page_digests, payload,
                 deadline_remaining=None, shards=1,
                 head_layout=CANONICAL_HEAD_LAYOUT, checksum=None):
        self.version = int(version)
        self.prompt = np.asarray(prompt, np.int64)
        self.tokens = [int(t) for t in tokens]
        self.pos = int(pos)
        self.count = int(count)
        self.last = int(last)
        self.key = np.asarray(key, np.uint32)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.seed = int(seed)
        self.eos_id = None if eos_id is None else int(eos_id)
        self.max_tokens = int(max_tokens)
        self.kv_dtype = kv_dtype
        self.page_size = int(page_size)
        self.page_token_bytes = int(page_token_bytes)
        self.page_digests: List[Optional[bytes]] = list(page_digests)
        self.payload = payload
        #: remaining request Deadline budget (seconds) at pack time — a
        #: duration, not a timestamp, so adoption on another host with a
        #: skewed wall clock re-arms the same budget (monotonic-deadline
        #: rule). None = the request carried no deadline.
        self.deadline_remaining = None if deadline_remaining is None \
            else float(deadline_remaining)
        #: v3 mesh-aware page geometry: how many head shards the
        #: EXPORTING server decoded over (diagnostics — the payload is
        #: canonical regardless) and the payload's head-axis layout.
        #: A version-2 snapshot keeps the implied single-chip values.
        self.shards = int(shards)
        self.head_layout = str(head_layout)
        self.checksum = checksum if checksum is not None \
            else self.content_digest()

    # ------------------------------------------------------ integrity
    def _header(self) -> dict:
        # the sharded-geometry fields join the header at v3 ONLY: a
        # version-2 snapshot built by this writer (downgrade_snapshot)
        # stays byte-identical — header, checksum and framing — to one
        # a pre-v3 writer would emit, which is what keeps the v2 adopt
        # fallback honest
        hdr = {
            "version": self.version,
            "prompt": self.prompt.tolist(),
            "tokens": self.tokens,
            "pos": self.pos,
            "count": self.count,
            "last": self.last,
            "key": self.key.tolist(),
            "temperature": self.temperature,
            "top_k": self.top_k,
            "seed": self.seed,
            "eos_id": self.eos_id,
            "max_tokens": self.max_tokens,
            "kv_dtype": self.kv_dtype,
            "page_size": self.page_size,
            "page_token_bytes": self.page_token_bytes,
            "deadline_remaining": self.deadline_remaining,
            "page_digests": [None if d is None else d.hex()
                             for d in self.page_digests],
            "leaves": [[vn, leaf, _wire_name(a), list(a.shape)]
                       for vn, leaf, a in _leaf_items(self.payload)],
        }
        if self.version >= 3:
            hdr["shards"] = self.shards
            hdr["head_layout"] = self.head_layout
        return hdr

    def content_digest(self) -> bytes:
        """sha256 over the canonical header AND every payload byte —
        a single flipped bit anywhere fails ``verify()``."""
        h = hashlib.sha256()
        h.update(_MAGIC)
        h.update(json.dumps(self._header(), sort_keys=True).encode())
        for _vn, _leaf, a in _leaf_items(self.payload):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.digest()

    def verify(self) -> bool:
        return self.checksum == self.content_digest()

    @property
    def n_pages(self) -> int:
        return len(self.page_digests)

    def wire_bytes(self) -> int:
        """Size of the serialized snapshot — the ``handoff_bytes``
        accounting (int8 KV shows up here as the ~3.55x shrink)."""
        header = json.dumps(self._header(), sort_keys=True).encode()
        n = len(_MAGIC) + 2 + 4 + len(header) + len(self.checksum)
        for _vn, _leaf, a in _leaf_items(self.payload):
            n += a.nbytes
        return n

    # -------------------------------------------------- serialization
    def to_bytes(self) -> bytes:
        header = json.dumps(self._header(), sort_keys=True).encode()
        parts = [_MAGIC, struct.pack("<HI", self.version, len(header)),
                 header]
        for _vn, _leaf, a in _leaf_items(self.payload):
            parts.append(np.ascontiguousarray(a).tobytes())
        parts.append(self.checksum)
        return b"".join(parts)

    #: wire versions this reader can PARSE (framing + header keys).
    #: Parseable is weaker than adoptable: a cross-version read is
    #: refused typed AFTER the header parse, so the refusal can name the
    #: full geometry tuple instead of degenerating into a checksum error.
    KNOWN_VERSIONS = (2, 3)

    @classmethod
    def from_bytes(cls, blob: bytes, *,
                   supported: int = WIRE_VERSION) -> "KVSnapshot":
        """Deserialize one snapshot. ``supported`` is the reader's own
        wire generation (a v2-geometry decode tier passes 2): a KNOWN
        version that differs from it fails typed ``SnapshotUnsupported``
        with the geometry tuple (version/shards/head_layout/kv_dtype/
        page geometry) in the message — never a checksum error, never a
        silent truncation — while an UNKNOWN version fails
        ``SnapshotInvalid`` before any parsing is trusted."""
        if len(blob) < len(_MAGIC) + 6 or not blob.startswith(_MAGIC):
            raise SnapshotInvalid("not a KVSnapshot byte stream")
        off = len(_MAGIC)
        version, hlen = struct.unpack_from("<HI", blob, off)
        if version not in cls.KNOWN_VERSIONS:
            raise SnapshotInvalid(
                f"KVSnapshot wire version {version} != supported "
                f"{supported}")
        off += 6
        try:
            hdr = json.loads(blob[off:off + hlen].decode())
        except Exception as e:
            raise SnapshotInvalid(f"unreadable snapshot header: {e}")
        if version != supported:
            raise SnapshotUnsupported(
                "cross-version KVSnapshot refused before adoption: "
                f"geometry (version={version}, "
                f"shards={hdr.get('shards', 1)}, "
                f"head_layout={hdr.get('head_layout', CANONICAL_HEAD_LAYOUT)!r}, "
                f"kv_dtype={hdr.get('kv_dtype')!r}, "
                f"page_size={hdr.get('page_size')}, "
                f"page_token_bytes={hdr.get('page_token_bytes')}) from a "
                f"v{version} writer at a v{supported}-geometry reader")
        off += hlen
        payload: Dict[str, Dict[str, np.ndarray]] = {}
        for vn, leaf, dtype, shape in hdr["leaves"]:
            a = np.frombuffer(
                blob, dtype=_wire_dtype(dtype), offset=off,
                count=int(np.prod(shape, dtype=np.int64))
            ).reshape(shape).copy()
            payload.setdefault(vn, {})[leaf] = a
            off += a.nbytes
        checksum = blob[off:off + 32]
        snap = cls(
            version=version, prompt=hdr["prompt"], tokens=hdr["tokens"],
            pos=hdr["pos"], count=hdr["count"], last=hdr["last"],
            key=hdr["key"], temperature=hdr["temperature"],
            top_k=hdr["top_k"], seed=hdr["seed"], eos_id=hdr["eos_id"],
            max_tokens=hdr["max_tokens"], kv_dtype=hdr["kv_dtype"],
            page_size=hdr["page_size"],
            page_token_bytes=hdr["page_token_bytes"],
            page_digests=[None if d is None else bytes.fromhex(d)
                          for d in hdr["page_digests"]],
            payload=payload,
            deadline_remaining=hdr["deadline_remaining"],
            shards=hdr.get("shards", 1),
            head_layout=hdr.get("head_layout", CANONICAL_HEAD_LAYOUT),
            checksum=checksum)
        if not snap.verify():
            raise SnapshotInvalid("KVSnapshot checksum mismatch")
        return snap


def peek_snapshot(blob: bytes) -> dict:
    """Parse ONLY the wire framing and JSON header of a serialized
    snapshot — no payload copy, no checksum pass — for routers (the
    fleet federation) that ship snapshots as opaque bytes but need the
    stream position to order competing harvests. Returns a dict with
    ``version``, ``count``, ``pos``, ``tokens`` (generated so far),
    ``deadline_remaining`` and ``wire_bytes``. A malformed prefix fails
    typed ``SnapshotInvalid``; a KNOWN-but-foreign version still peeks
    fine (the refusal decision belongs to the adopting host, which runs
    the full ``from_bytes`` geometry check)."""
    if len(blob) < len(_MAGIC) + 6 or not blob.startswith(_MAGIC):
        raise SnapshotInvalid("not a KVSnapshot byte stream")
    off = len(_MAGIC)
    version, hlen = struct.unpack_from("<HI", blob, off)
    if version not in KVSnapshot.KNOWN_VERSIONS:
        raise SnapshotInvalid(
            f"KVSnapshot wire version {version} is unknown to this "
            "reader")
    off += 6
    if hlen > len(blob) - off:
        raise SnapshotInvalid(
            f"snapshot header length {hlen} exceeds the {len(blob)}-byte "
            "blob — truncated or corrupt framing")
    try:
        hdr = json.loads(blob[off:off + hlen].decode())
    except Exception as e:
        raise SnapshotInvalid(f"unreadable snapshot header: {e}")
    return {"version": version,
            "count": hdr.get("count", 0),
            "pos": hdr.get("pos", 0),
            "tokens": len(hdr.get("tokens", ())),
            "deadline_remaining": hdr.get("deadline_remaining"),
            "wire_bytes": len(blob)}


def pack_snapshot(*, req, pos, count, last, key, kv_dtype, page_size,
                  page_token_bytes, page_digests, fetched, n_pages,
                  shards=1,
                  head_layout=CANONICAL_HEAD_LAYOUT) -> KVSnapshot:
    """Assemble a ``KVSnapshot`` from the server's host mirrors plus one
    fetched page stack. ``fetched`` is the block-table-width device
    fetch ``{vertex: {leaf: [NP, ...]}}``; only the first ``n_pages``
    rows hold this slot's resident KV. Every host conversion (int casts,
    list copies, array slices) happens HERE, outside the serving loop's
    hot-named functions. The request's remaining Deadline budget is
    captured as a duration so the adopter re-arms the same clock."""
    n = int(n_pages)
    payload = {vn: {leaf: np.ascontiguousarray(a[:n])
                    for leaf, a in leaves.items()}
               for vn, leaves in fetched.items()}
    deadline = getattr(req, "deadline", None)
    remaining = None if deadline is None else max(0.0,
                                                 deadline.remaining())
    return KVSnapshot(
        version=WIRE_VERSION, prompt=req.prompt, tokens=list(req.tokens),
        pos=pos, count=count, last=last, key=key,
        temperature=req.temperature, top_k=req.top_k, seed=req.seed,
        eos_id=req.eos_id, max_tokens=req.max_tokens, kv_dtype=kv_dtype,
        page_size=page_size, page_token_bytes=page_token_bytes,
        page_digests=list(page_digests)[:n], payload=payload,
        deadline_remaining=remaining, shards=shards,
        head_layout=head_layout)


def downgrade_snapshot(snap: KVSnapshot) -> KVSnapshot:
    """Re-emit a v3 snapshot as wire v2 — byte-identical (header,
    framing, checksum) to what a pre-v3 writer would have produced for
    the same request, which is possible precisely because the v3 payload
    layout IS the v2 layout (canonical host stacks). The bridge for
    shipping to a fleet tier still running v2-geometry readers; refuses
    a non-canonical layout loudly rather than emit bytes a v2 reader
    would misinterpret."""
    if snap.head_layout != CANONICAL_HEAD_LAYOUT:
        raise SnapshotUnsupported(
            f"cannot downgrade a {snap.head_layout!r}-layout snapshot "
            "to wire v2: v2 readers only speak the canonical host "
            "layout")
    return KVSnapshot(
        version=2, prompt=snap.prompt, tokens=list(snap.tokens),
        pos=snap.pos, count=snap.count, last=snap.last, key=snap.key,
        temperature=snap.temperature, top_k=snap.top_k, seed=snap.seed,
        eos_id=snap.eos_id, max_tokens=snap.max_tokens,
        kv_dtype=snap.kv_dtype, page_size=snap.page_size,
        page_token_bytes=snap.page_token_bytes,
        page_digests=list(snap.page_digests), payload=snap.payload,
        deadline_remaining=snap.deadline_remaining)


def padded_payload(snap: KVSnapshot, np_pages: int
                   ) -> Dict[str, Dict[str, np.ndarray]]:
    """Zero-pad the snapshot's ``[n, ...]`` page stacks to the adopting
    server's block-table width ``[NP, ...]`` so the one compiled store
    program fits every adopt (pad rows are routed to the garbage page)."""
    out: Dict[str, Dict[str, np.ndarray]] = {}
    for vn, leaves in snap.payload.items():
        out[vn] = {}
        for leaf, a in leaves.items():
            padded = np.zeros((np_pages,) + a.shape[1:], a.dtype)
            padded[:a.shape[0]] = a
            out[vn][leaf] = padded
    return out


def corrupt_snapshot(snap: KVSnapshot) -> KVSnapshot:
    """Flip one payload bit *after* the checksum was computed — the
    chaos injector's ``snapshot_corrupt`` mode and the test hook for the
    checksum-fallback path. Returns the same (now invalid) snapshot."""
    for vn, leaf, a in _leaf_items(snap.payload):
        if a.size:
            # leaves off device transfers / frombuffer are read-only:
            # mutate a copy and swap it into the payload tree
            b = np.array(a)
            flat = b.view(np.uint8).reshape(-1)
            flat[0] ^= 0xFF
            snap.payload[vn][leaf] = b
            return snap
    # pathological empty payload: break the checksum directly
    snap.checksum = bytes(32)
    return snap


def truncate_snapshot(snap: KVSnapshot) -> KVSnapshot:
    """Zero the tail half of the last payload leaf *after* the checksum
    was computed — the chaos injector's ``handoff_truncate`` mode: the
    wire analog of a transfer cut short, where the missing tail reads
    back as zeros and the adopter's ``verify()`` fails before any page
    lands in its pool. Returns the same (now invalid) snapshot."""
    last_leaf = None
    for vn, leaf, a in _leaf_items(snap.payload):
        if a.size:
            last_leaf = (vn, leaf, a)
    if last_leaf is None:
        snap.checksum = bytes(32)
        return snap
    vn, leaf, a = last_leaf
    b = np.array(a)  # device fetches / frombuffer views are read-only
    flat = b.view(np.uint8).reshape(-1)
    flat[flat.size // 2:] = 0
    if np.array_equal(b, a):
        flat[-1] ^= 0xFF  # tail was already zeros: still break content
    snap.payload[vn][leaf] = b
    return snap


def export_request(server, future, timeout: Optional[float] = 30.0
                   ) -> KVSnapshot:
    """Snapshot the live request behind ``future`` on ``server`` (a
    ``GenerationServer``). Raises ``SnapshotUnavailable`` when the
    request is not resident in a slot."""
    return server.export_request(future, timeout=timeout)


def adopt_request(server, snapshot: KVSnapshot, **kwargs):
    """Adopt ``snapshot`` into a free slot of ``server`` and resume
    decoding at position N. Returns the Future of the resumed request;
    its result is byte-identical to the never-interrupted completion."""
    return server.adopt_request(snapshot, **kwargs)

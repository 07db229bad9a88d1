"""Port of ``src/repro/core/objectstore.py`` (copied; imports re-pointed).

S3-model object store (paper §III): durable KV with multipart parallel
GET/PUT, presigned scoped tokens, content-addressed caching (repeated sends
of the same model reuse the cached key), TTL GC, and fault-injected
retries.

Functionally real (bytes stored in memory / spillable to disk); timing is
charged through netsim: each connection sustains ``S3_CONN_BW``; a client
fetching with N parts gets min(N * S3_CONN_BW, its region multi-conn BW).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import os
import pickle
import secrets
import time
from typing import Any, Dict, Optional

from repro_torch.core.netsim import MB, Host, Region, Transfer
from repro_torch.core.serialization import WireData

S3_CONN_BW = 55 * MB  # per-connection GET/PUT throughput
S3_REQ_LATENCY = 0.030  # request handling latency (s)
S3_MAX_PARTS = 16


@dataclasses.dataclass
class S3Object:
    key: str
    nbytes: int
    wire: Optional[WireData]  # None for virtual payloads
    etag: str
    created: float
    version: int


class PresignedURL:
    """Scoped, time-limited token (paper's security story for S3 leg)."""

    def __init__(self, key: str, mode: str, expires_at: float):
        self.key = key
        self.mode = mode  # get | put
        self.expires_at = expires_at
        self.token = secrets.token_hex(8)

    def valid(self, key: str, mode: str, now: float) -> bool:
        return key == self.key and mode == self.mode and now <= self.expires_at


class ObjectStore:
    """One bucket, hub-region hosted."""

    def __init__(self, region: Region, *, fail_rate: float = 0.0, seed: int = 0):
        self.region = region
        self._objects: Dict[str, S3Object] = {}
        self._versions = itertools.count(1)
        self._fail_rate = fail_rate
        self._rng_state = seed
        self.stats = {"puts": 0, "gets": 0, "retries": 0, "bytes_put": 0,
                      "bytes_get": 0, "cache_hits": 0}
        # bucket-wide content index: (payload fingerprint, stack
        # signature) -> (key, uploader job, upload-done time). Keyed
        # WITHOUT a job namespace on purpose — two tenants shipping the
        # same base model through the same wire stack share one PUT
        self._content_index: Dict[Any, tuple] = {}

    # -- content-addressed keys ----------------------------------------
    @staticmethod
    def content_key(fingerprint: int, round_: int, sender: str) -> str:
        h = hashlib.sha1(f"{fingerprint}".encode()).hexdigest()[:16]
        return f"models/{sender}/r{round_}/{h}"

    def has(self, key: str) -> bool:
        return key in self._objects

    def size(self, key: str) -> int:
        """Stored wire bytes (a HEAD request — no data-plane stats)."""
        return self._objects[key].nbytes

    def note_cache_hit(self):
        """A caller reused a content-addressed key instead of re-PUTting.
        Callers must not poke ``store.stats`` directly (see
        scripts/check_stats_discipline.py)."""
        self.stats["cache_hits"] += 1

    # -- bucket-wide content index -------------------------------------
    def note_content(self, fingerprint, key: str, job: str = "",
                     done: float = 0.0):
        """Record that ``key`` holds the wire for ``fingerprint`` (a
        (payload fingerprint, stack signature) pair), uploaded by tenant
        ``job`` and durable from ``done`` on."""
        self._content_index[fingerprint] = (key, job, done)

    def content_lookup(self, fingerprint) -> Optional[tuple]:
        """-> (key, uploader job, upload-done time) if an object with
        this content identity is still stored, else None. This is the
        cross-sender (and cross-job) half of the content-addressed
        cache: senders consult it before encoding a fresh PUT."""
        ent = self._content_index.get(fingerprint)
        if ent is None or ent[0] not in self._objects:
            return None
        return ent

    # -- data plane ------------------------------------------------------
    def _maybe_fail(self) -> bool:
        # deterministic pseudo-randomness (no wall clock)
        self._rng_state = (self._rng_state * 6364136223846793005 + 1) % 2 ** 63
        return (self._rng_state / 2 ** 63) < self._fail_rate

    def put(self, key: str, wire: Optional[WireData], nbytes: int,
            now: float) -> S3Object:
        self.stats["puts"] += 1
        self.stats["bytes_put"] += nbytes
        etag = hashlib.sha1(f"{key}:{nbytes}".encode()).hexdigest()[:12]
        obj = S3Object(key=key, nbytes=nbytes, wire=wire, etag=etag,
                       created=now, version=next(self._versions))
        self._objects[key] = obj
        return obj

    def get(self, key: str, *, max_retries: int = 3):
        """Returns (S3Object, n_attempts). Raises KeyError if missing."""
        attempts = 1
        while self._maybe_fail() and attempts <= max_retries:
            self.stats["retries"] += 1
            attempts += 1
        if key not in self._objects:
            raise KeyError(f"s3: no such key {key}")
        obj = self._objects[key]
        self.stats["gets"] += 1
        self.stats["bytes_get"] += obj.nbytes
        return obj, attempts

    def delete(self, key: str):
        self._objects.pop(key, None)

    def gc(self, now: float, ttl: float):
        dead = [k for k, o in self._objects.items() if now - o.created > ttl]
        for k in dead:
            del self._objects[k]
        return len(dead)

    def presign(self, key: str, mode: str, now: float,
                ttl: float = 3600.0) -> PresignedURL:
        return PresignedURL(key, mode, now + ttl)

    # -- timing model ------------------------------------------------------
    def put_time(self, nbytes: int, src: Host, parts: int = S3_MAX_PARTS) -> float:
        """Multipart upload from src to the bucket region."""
        cap = min(parts * S3_CONN_BW, src.region.bw_multi, src.uplink)
        return S3_REQ_LATENCY + src.region.latency + nbytes / cap

    def get_time(self, nbytes: int, dst: Host, parts: int = S3_MAX_PARTS) -> float:
        cap = min(parts * S3_CONN_BW, dst.region.bw_multi, dst.downlink)
        return S3_REQ_LATENCY + dst.region.latency + nbytes / cap

    def get_transfer(self, key: str, dst: Host, start: float,
                     parts: int = S3_MAX_PARTS) -> Transfer:
        """A Transfer for the fluid solver (S3 side is effectively
        unconstrained: independent per-client download pipes)."""
        obj = self._objects[key]
        s3_host = Host("s3", self.region, float("inf"), float("inf"))
        cap_region = Region(
            f"s3-{dst.region.name}",
            bw_single=S3_CONN_BW,
            bw_multi=min(parts * S3_CONN_BW, dst.region.bw_multi),
            latency=S3_REQ_LATENCY + dst.region.latency)
        return Transfer(start=start, src=s3_host, dst=dst, nbytes=obj.nbytes,
                        conns=parts, link_region=cap_region, tag=f"get:{key}")

"""Persistent program cache for serving lanes, the port of
``repro.serving.compile_cache``.

The cold-start problem is the reference's: a restarted replica would pay
for building every lane program on its first request at each lane key. In
the port a lane program (``scheduler.lane_program``) is the lane's
storage in the kernels' layout plus, on the card, a CUDA graph of one
chunk captured over that storage (``kernels.ops.AsyncLane``), or, on the
eager backend, a callable over a ``SwarmBatch``.

**What differs from ``jax.export``.** The reference serializes each traced
program and a restarted replica deserializes it: the Python body never
runs again. A CUDA graph cannot be serialized (it holds device addresses
of one process's buffers), so the disk layer here is a MANIFEST: the lane
program keys and, for each, the JSON spec that rebuilds the program
(solve shape, ``sync_every``, width, rule, topology, backend, device,
built-in objective or the heterogeneous table). ``prewarm()`` loads the
kernel libraries (``kernels._build.load``: ``nvcc`` runs only where the
hashed ``.so`` under ``build/repro_torch/`` is missing) and builds every
manifest program, capturing its graph, before the first request arrives.
The builds persist on disk; the graphs are captured again in each process.
A custom Problem's program (the split path, the user's torch step) has no
spec that a new process could rebuild it from: it is memoized in process
only, counted as any build. The reference's ``enable_xla_cache`` has no
counterpart: there is no XLA compile to point at a cache.

Resolution order (``get``), as in the reference: the in-process memo, then
the manifest (a build from its spec), then a fresh build that is recorded
in the manifest. The manifest records a fingerprint (torch version, CUDA
version, device name, the kernel sources' build tags) and is ignored on a
mismatch.

Observability: ``aot_hits`` / ``aot_misses``, and ``trace_events``, the
builds made inside ``get``, on the request path. A warm replica (after
``prewarm()``) serving its first request reports ``trace_events == 0``.

**A program holds rows.** The reference's programs are pure functions, so
any number of schedulers may share them. Here a program owns its lane's
storage (and, on the card, a graph over it), so two schedulers that share
one cache and both have rows in flight at one key would write into the
same columns. ``claim``/``release`` make that an error: a scheduler's lane
claims its program while it holds rows and releases it when it empties,
so schedulers may take turns on a key but never interleave on it.
"""
from __future__ import annotations

import hashlib
import json
import os
import weakref
from typing import Callable, Dict, Optional

CACHE_ENV = "REPRO_COMPILE_CACHE"
_MANIFEST = "manifest.json"
_SOURCES = ("pso_step", "pso_split")


def _fingerprint() -> Dict[str, object]:
    import torch

    from ..kernels import _build
    return {"torch": torch.__version__, "cuda": torch.version.cuda,
            "device": (torch.cuda.get_device_name(0)
                       if torch.cuda.is_available() else "cpu"),
            "kernels": {name: _build.tag(name) for name in _SOURCES}}


class CompileCache:
    """Disk-backed manifest of lane programs, memoized in process.

    ``path=None`` reads ``REPRO_COMPILE_CACHE``; if that is unset too the
    cache is memory-only (it still builds each program once a process).
    ``metrics`` is an optional ``ServingMetrics`` sink for the hit, miss
    and build counters (kept here as well).

    A program holds its lane's rows: one lane at a time may hold rows in
    what ``get`` returns for a key (``claim``).
    """

    def __init__(self, path: Optional[str] = None, metrics=None):
        self.path = path if path is not None else os.environ.get(CACHE_ENV)
        self.metrics = metrics
        self._mem: Dict[str, object] = {}
        self.aot_hits = 0
        self.aot_misses = 0
        self.trace_events = 0
        self._manifest: Optional[dict] = None
        self._owners: Dict[str, weakref.ref] = {}

    def _count(self, name: str, k: int = 1) -> None:
        setattr(self, name, getattr(self, name) + k)
        if self.metrics is not None:
            self.metrics.inc(name, k)

    @staticmethod
    def _file_key(key: str) -> str:
        return hashlib.sha1(key.encode()).hexdigest()

    # -- manifest ----------------------------------------------------------
    def _load_manifest(self) -> dict:
        if self._manifest is not None:
            return self._manifest
        fp = _fingerprint()
        doc = {"fingerprint": fp, "entries": {}}
        if self.path:
            try:
                with open(os.path.join(self.path, _MANIFEST)) as f:
                    on_disk = json.load(f)
                if on_disk.get("fingerprint") == fp:
                    doc = on_disk
            except (OSError, ValueError):
                pass
        self._manifest = doc
        return doc

    def _save_manifest(self) -> None:
        if not self.path or self._manifest is None:
            return
        try:
            os.makedirs(self.path, exist_ok=True)
            tmp = os.path.join(self.path, f".{_MANIFEST}.{os.getpid()}")
            with open(tmp, "w") as f:
                json.dump(self._manifest, f, indent=1, sort_keys=True)
            os.replace(tmp, os.path.join(self.path, _MANIFEST))
        except OSError:
            pass    # the cache saves builds; it never fails a solve

    def _spec(self, key: str) -> Optional[dict]:
        if not self.path:
            return None
        entry = self._load_manifest()["entries"].get(self._file_key(key))
        return None if entry is None else entry.get("spec")

    def _record(self, key: str, spec: dict) -> None:
        if not self.path:
            return
        man = self._load_manifest()
        man["entries"][self._file_key(key)] = {"key": key, "spec": spec}
        self._save_manifest()

    # -- the cache ---------------------------------------------------------
    def get(self, key: str, build: Callable[[], object],
            spec: Optional[dict] = None):
        """The program for ``key``, built at most once a process.

        ``build()`` makes it; ``spec`` (JSON-able, or None for a program no
        other process could rebuild) is what ``prewarm`` rebuilds it from
        (``scheduler.lane_program(spec)``). Resolution order: in-process
        memo -> manifest entry (a build from its spec; a hit) -> a fresh
        build (a miss), recorded in the manifest. Every build made here
        counts in ``trace_events``.
        """
        hit = self._mem.get(key)
        if hit is not None:
            self._count("aot_hits")
            return hit
        if spec is not None and self._spec(key) == spec:
            self._count("aot_hits")
        else:
            self._count("aot_misses")
            if spec is not None:
                self._record(key, spec)
        self._count("trace_events")
        program = self._mem[key] = build()
        return program

    def claim(self, key: str, owner) -> None:
        """Record that ``owner`` (a scheduler's lane) holds rows in the
        program at ``key``. Raises if another live owner holds rows there:
        two schedulers on one cache would overwrite each other's rows."""
        held = self._owners.get(key)
        other = None if held is None else held()
        if other is not None and other is not owner:
            raise RuntimeError(
                f"the lane program {key!r} holds another scheduler's rows; "
                f"schedulers that share a CompileCache take turns on a "
                f"lane key, or each takes a cache of its own")
        self._owners[key] = weakref.ref(owner)

    def release(self, key: str, owner) -> None:
        """``owner`` holds no rows in the program at ``key`` any more."""
        held = self._owners.get(key)
        if held is not None and held() is owner:
            del self._owners[key]

    def prewarm(self) -> int:
        """Build every manifest program into the in-process memo (replica
        startup; on the card each build captures its lane's CUDA graph).
        Returns how many programs are servable without a build on the
        request path. A build that fails raises."""
        if not self.path:
            return 0
        from .scheduler import lane_program
        for entry in self._load_manifest()["entries"].values():
            key, spec = entry.get("key"), entry.get("spec")
            if not isinstance(spec, dict) or key in self._mem:
                continue
            self._mem[key] = lane_program(spec)
        return len(self._mem)

    def snapshot(self) -> dict:
        return {"path": self.path, "programs": len(self._mem),
                "aot_hits": self.aot_hits, "aot_misses": self.aot_misses,
                "trace_events": self.trace_events}

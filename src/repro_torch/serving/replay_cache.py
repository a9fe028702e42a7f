"""Content-addressed replay cache — the multi-tenant heart of the edge server.

After the Operator Sequence Search locks an inference operator sequence
(IOS), every inference costs a few RPCs instead of thousands.  A
single-tenant server pays the search *and* the replay program once per
client; clients running the same model produce the same IOS, so the server
keys :class:`~repro_torch.core.engine.ReplayProgram`s by the canonical IOS
fingerprint (:func:`repro_torch.core.opseq.ios_fingerprint`) and shares them:

* a client whose recorded log matches a cached fingerprint adopts the IOS
  after a *single* recorded inference (no ``min_repeats`` wait), so the
  recording-phase RPCs of a fleet grow sublinearly in its client count;
* a program is built exactly once per fingerprint;
* eviction is LRU, bounded by entry count *and* by the programs' byte
  estimate (``capacity_bytes``).  Fingerprints can be **pinned** (residency
  for a paying tenant's model); a pin also covers the entries derived from
  the fingerprint (``fp|plan`` segmented programs, ``fp#vmap<n>`` batched
  programs).

The cache stores only *programs* (pure functions of the recorded payloads);
per-client address bindings live in each client's
:class:`~repro_torch.core.engine.ClientContext`.

Persistence: :meth:`ReplayCache.save` / :meth:`ReplayCache.load` write and
read the *fingerprint metadata*, not the programs, which are rebuilt cheaply
from a client's recorded calls.  A restarted edge server that loads a cache
file knows every previously validated IOS: a client whose single recorded
inference matches a persisted fingerprint adopts it at once, and the server
builds the program on the first replay (stateful again, from the persisted
carried pairs).  Segmented programs live under composite ``fp|plan`` keys,
whose metadata persists the plan signature and the carried pairs the same
way.
"""
from __future__ import annotations

import json
import os
from collections import OrderedDict
from typing import Any, Dict, Optional, Set

from repro_torch.obs import MetricsRegistry, RegistryBackedStats

PERSIST_VERSION = 1

# programs that cannot report their size are assumed mid-sized, so they
# still take part in byte-aware eviction
DEFAULT_PROGRAM_NBYTES = 1 << 20


class CacheStats(RegistryBackedStats):
    """Replay-cache counters, registry-backed: a fleet root's snapshot
    reports every replica's hits, misses and evictions under its scope."""

    _fields = (
        ("hits", 0),
        ("misses", 0),
        ("insertions", 0),
        ("evictions", 0),
        ("bytes_evicted", 0.0),
    )

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        return dict(super().as_dict(), hit_rate=self.hit_rate)


def program_nbytes(program: Any) -> int:
    """Byte estimate of a cached program: the tensors it holds and its
    output staging buffers (``ReplayProgram.nbytes_estimate``)."""
    return int(getattr(program, "nbytes_estimate", DEFAULT_PROGRAM_NBYTES))


def base_fingerprint(key: str) -> str:
    """Collapse a derived cache key (``fp|plan`` segmented program,
    ``fp#vmap<n>`` batched program) to the IOS fingerprint that owns it."""
    return key.split("|", 1)[0].split("#", 1)[0]


class ReplayCache:
    """LRU map: IOS fingerprint -> :class:`ReplayProgram`.

    Each entry carries a byte estimate; an insert evicts least-recently-used
    *unpinned* entries while the entry count exceeds ``capacity`` or the
    byte total exceeds ``capacity_bytes`` (when set).  ``pin()`` grants a
    fingerprint — and every entry derived from it — residency.  ``metrics``
    is the registry scope of its :class:`CacheStats`."""

    def __init__(self, capacity: int = 8, capacity_bytes: Optional[float] = None,
                 metrics: Optional[MetricsRegistry] = None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        if capacity_bytes is not None and capacity_bytes <= 0:
            raise ValueError(f"capacity_bytes must be positive, got {capacity_bytes}")
        self.capacity = capacity
        self.capacity_bytes = capacity_bytes
        self._entries: "OrderedDict[str, Any]" = OrderedDict()
        self._nbytes: Dict[str, int] = {}
        self._pinned: set = set()
        # transient claims: base fingerprint -> refcount.  A claim on a
        # derived key pins its base for the claim's lifetime: an in-flight
        # batch round must not have its base evicted (and the derived
        # program purged with it) while it executes.
        self._claims: Dict[str, int] = {}
        # fingerprints known from a persisted cache file whose programs have
        # not been built since the restart: metadata only
        self._known: Dict[str, Dict[str, Any]] = {}
        self.stats = CacheStats(registry=metrics)

    def __contains__(self, fingerprint: str) -> bool:
        # membership probes (the client-side cache-adoption check) count as
        # neither hits nor misses; only get() does.  A persisted fingerprint
        # is a member: the IOS is validated, the program is built on first use
        return fingerprint in self._entries or fingerprint in self._known

    def __len__(self) -> int:
        return len(self._entries) + sum(1 for fp in self._known if fp not in self._entries)

    def get(self, fingerprint: str) -> Optional[Any]:
        program = self._entries.get(fingerprint)
        if program is None:
            self.stats.misses += 1
            return None
        self._entries.move_to_end(fingerprint)
        self.stats.hits += 1
        return program

    def peek(self, key: str) -> Optional[Any]:
        """The entry under ``key``, leaving LRU order and stats alone."""
        return self._entries.get(key)

    def put(self, fingerprint: str, program: Any) -> None:
        if fingerprint in self._entries:
            self._entries.move_to_end(fingerprint)
        self._entries[fingerprint] = program
        self._nbytes[fingerprint] = program_nbytes(program)
        self.stats.insertions += 1
        self._evict(keep=fingerprint)

    def ios_lengths(self) -> Optional[Set[int]]:
        """Record counts of the IOSes a probe can match, or None when one is
        unknown (a persisted entry written without it)."""
        lengths = [getattr(p, "n_records", None) for fp, p in self._entries.items()
                   if base_fingerprint(fp) == fp]
        lengths += [meta.get("n_records") for fp, meta in self._known.items()
                    if fp not in self._entries and base_fingerprint(fp) == fp]
        return None if None in lengths else {int(n) for n in lengths}

    def _over_budget(self) -> bool:
        if len(self._entries) > self.capacity:
            return True
        return self.capacity_bytes is not None and self.bytes_total > self.capacity_bytes

    def _evict(self, keep: str) -> None:
        """Evict LRU-first until within the entry *and* byte budgets.  Pinned
        entries are never evicted.  Derived ``#vmap`` programs go before any
        base program (they are cheap rebuilds; losing a base forces a
        rebuild and breaks program-identity sharing for bound clients), and
        evicting a base purges its derived entries.  The just-inserted entry
        goes last — but when every other resident entry is pinned it is
        evicted too (unless it is the only entry: a single program larger
        than the whole byte budget stays rather than thrashing)."""

        def pop(victim: str) -> None:
            self._entries.pop(victim)
            self.stats.evictions += 1
            self.stats.bytes_evicted += self._nbytes.pop(victim, 0)

        while self._over_budget():
            candidates = [fp for fp in self._entries if fp != keep and not self.is_pinned(fp)]
            victim = next((fp for fp in candidates if "#" in fp), None) or next(
                iter(candidates), None
            )
            if victim is None:
                if keep in self._entries and len(self._entries) > 1 and not self.is_pinned(keep):
                    pop(keep)
                return
            pop(victim)
            if "#" not in victim:
                for fp in [k for k in self._entries if k.startswith(victim + "#")]:
                    pop(fp)

    # -- pinning & sizes ------------------------------------------------
    def pin(self, fingerprint: str) -> None:
        """Grant ``fingerprint`` (and its derived entries) residency."""
        self._pinned.add(fingerprint)

    def unpin(self, fingerprint: str) -> None:
        self._pinned.discard(fingerprint)
        self._evict(keep="")

    def claim(self, key: str) -> None:
        """Pin ``key``'s *base* fingerprint while a derived program is in
        use (a batch round executing ``fp#vmap<n>``) until the matching
        :meth:`release`.  Claims nest (refcounted)."""
        base = base_fingerprint(key)
        self._claims[base] = self._claims.get(base, 0) + 1

    def release(self, key: str) -> None:
        base = base_fingerprint(key)
        n = self._claims.get(base, 0) - 1
        if n <= 0:
            self._claims.pop(base, None)
        else:
            self._claims[base] = n
        self._evict(keep="")

    def is_pinned(self, key: str) -> bool:
        base = base_fingerprint(key)
        return base in self._pinned or self._claims.get(base, 0) > 0

    @property
    def bytes_total(self) -> int:
        """Byte estimate of every resident program."""
        return sum(self._nbytes.get(fp, 0) for fp in self._entries)

    def entry_nbytes(self, key: str) -> Optional[int]:
        return self._nbytes.get(key) if key in self._entries else None

    @property
    def fingerprints(self):
        """Keys in LRU order (oldest first)."""
        return list(self._entries.keys())

    @property
    def persisted_fingerprints(self):
        """Fingerprints known from a loaded cache file (metadata only)."""
        return list(self._known.keys())

    def known_metadata(self, fingerprint: str) -> Optional[Dict[str, Any]]:
        return self._known.get(fingerprint)

    def forget_known(self, fingerprint: str) -> None:
        self._known.pop(fingerprint, None)

    # ------------------------------------------------------------------
    @staticmethod
    def _describe(program: Any) -> Dict[str, Any]:
        """JSON-safe metadata of a program."""
        meta: Dict[str, Any] = {}
        for attr in ("n_records", "n_kernels", "total_flops", "total_bytes"):
            v = getattr(program, attr, None)
            if v is not None:
                meta[attr] = v
        avals = getattr(program, "d2h_avals", None)
        if avals is not None:
            meta["d2h_avals"] = [[list(shape), str(dtype)] for shape, dtype in avals]
        plan = getattr(program, "plan", None)
        if hasattr(plan, "signature"):
            meta["plan"] = plan.signature()
        carried = getattr(program, "carried_pairs", None)
        if carried:
            # a restarted server rebuilds the program stateful, not as a
            # prefix-recomputing stateless replay
            meta["carried_pairs"] = [[int(i), int(j)] for i, j in carried]
        return meta

    def save(self, path: str) -> int:
        """Write fingerprint -> IOS metadata for every entry (built or still
        persisted); returns the number of fingerprints written.  Derived
        ``#vmap`` programs are skipped: they are rebuilt from the base on
        demand and carry no validation state."""
        entries = {fp: self._describe(p) for fp, p in self._entries.items() if "#" not in fp}
        for fp, meta in self._known.items():
            entries.setdefault(fp, meta)
        payload = {"version": PERSIST_VERSION, "fingerprints": entries}
        tmp = f"{path}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1, sort_keys=True)
        os.replace(tmp, path)  # atomic publish
        return len(entries)

    def load(self, path: str) -> int:
        """Merge a persisted cache file; returns the accepted fingerprint
        count.

        Loaded fingerprints are *validated IOS identities*, not programs:
        membership tests succeed (so clients skip the ``min_repeats``
        re-validation wait) while ``get()`` misses until the first client's
        calls rebuild the program.

        Each key and its metadata must pass the static verifier
        (:func:`repro_torch.analysis.plancheck.verify_persisted_entry`): an
        unsound entry is evicted with a warning, the sound ones merge, and
        the count returned is of the accepted entries."""
        import warnings

        from repro_torch.analysis.plancheck import verify_persisted_entry

        with open(path) as f:
            payload = json.load(f)
        version = payload.get("version")
        if version != PERSIST_VERSION:
            raise ValueError(f"unsupported replay-cache file version {version!r}")
        accepted = 0
        for fp, meta in payload["fingerprints"].items():
            diags = verify_persisted_entry(fp, meta)
            if diags:
                warnings.warn(
                    f"replay cache {path}: evicting persisted entry {fp!r}: "
                    + "; ".join(f"{d.code}: {d.message}" for d in diags),
                    stacklevel=2,
                )
                continue
            self._known[fp] = meta
            accepted += 1
        return accepted

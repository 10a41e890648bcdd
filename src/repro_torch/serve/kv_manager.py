"""Paged KV-cache pool accounting (host side), with content-addressed
prefix caching.

The device-side pool (``runtime.serve_step.init_pool``) is a fixed buffer
of ``page_sz``-row pages, sharded page-blockwise over the sequence-parallel
ranks (global page ``g`` on rank ``g // (n_pages / d_s)``), each rank with
a trash page of its own (host sentinel page id ``n_pages``) so padding
writes always have a home; at one rank ``[L, n_pages + 1, page_sz, Hkv,
Dh]``. The host keeps global page ids. This module is a copy
of the JAX package's host-side pool and owns the *host* view:

* **per-request page tables** — request ``r`` holds an ordered list of
  page ids; logical cache row ``i`` lives at row ``i % page_sz`` of page
  ``table[i // page_sz]``. Pages are allocated **on write** (admission
  reserves nothing), freed O(1), and fragmentation is impossible by
  construction: any free page serves any request.
* **content-addressed prefix cache** — a full page of committed tokens is
  *published* under its chain hash ``h_j = H(h_{j-1} || tokens_j)`` (so a
  page's identity covers its whole token prefix, which the KV rows depend
  on). A later prompt whose chain prefix is resident adopts those pages
  (refcounted sharing) instead of recomputing them; a prompt that diverges
  *inside* a published page adopts it partially and the first write
  triggers **copy-on-write** (``ensure_writable``). Freed pages keep their
  hash entry until actually reallocated (free-but-cached, vLLM-style), so
  a finished request's prefix keeps serving hits for free.

Invariants (property-tested in tests/test_serve_engine.py, asserted by
:meth:`PagedKVPool.check`):

* free pages and referenced pages partition ``range(n_pages)``;
* the trash page is never in a page table, the free list, or refcounted;
* ``refcount(p)`` == number of page tables referencing ``p``;
* published pages carry exactly ``page_sz`` recorded tokens and the
  hash index / children index / token store agree;
* COW never mutates a shared page — a write into a page with refcount
  > 1 swaps in a fresh page and leaves the shared one untouched.
"""

from __future__ import annotations

import hashlib
from collections import Counter, OrderedDict
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["PagedKVPool", "PoolStats"]


def _chain_hash(parent: Optional[bytes], tokens: Sequence[int]) -> bytes:
    """Chain hash of one page of tokens: covers the page's content AND its
    whole prefix (via ``parent``), because a KV row depends on every token
    before it, not just the tokens in its own page."""
    h = hashlib.sha256(parent or b"\x00")
    h.update(b"|")
    h.update(",".join(str(int(t)) for t in tokens).encode())
    return h.digest()


@dataclass
class PoolStats:
    allocs: int = 0              # fresh pages handed out (append + COW)
    frees: int = 0               # pages returned to the free list
    alloc_failures: int = 0      # page requests with an exhausted pool
    preemptions: int = 0         # running requests evicted for admission
    peak_in_use: int = 0         # max pages referenced at once
    peak_seqs: int = 0           # max concurrent page tables (resident reqs)
    prefix_hit_pages: int = 0    # pages adopted from the prefix cache
    prefix_hit_rows: int = 0     # cache rows those adoptions skipped
    cow_copies: int = 0          # shared pages copied before a write
    published: int = 0           # full pages entered into the hash index
    cache_evictions: int = 0     # cached-free pages reused (hash dropped)
    occupancy_sum: float = 0.0   # sum over sampled ticks of in_use/n_pages
    occupancy_ticks: int = 0

    @property
    def mean_occupancy(self) -> float:
        if not self.occupancy_ticks:
            return 0.0
        return self.occupancy_sum / self.occupancy_ticks

    def as_dict(self) -> Dict[str, float]:
        return {
            "allocs": self.allocs,
            "frees": self.frees,
            "alloc_failures": self.alloc_failures,
            "preemptions": self.preemptions,
            "peak_in_use": self.peak_in_use,
            "peak_seqs": self.peak_seqs,
            "prefix_hit_pages": self.prefix_hit_pages,
            "prefix_hit_rows": self.prefix_hit_rows,
            "cow_copies": self.cow_copies,
            "published": self.published,
            "cache_evictions": self.cache_evictions,
            "mean_occupancy": round(self.mean_occupancy, 4),
        }


class PagedKVPool:
    """Fixed pool of ``n_pages`` KV pages of ``page_sz`` rows each."""

    def __init__(self, n_pages: int, page_sz: int, *,
                 prefix_cache: bool = True):
        if n_pages < 1 or page_sz < 1:
            raise ValueError("n_pages and page_sz must be >= 1")
        self.n_pages = n_pages
        self.page_sz = page_sz
        self.prefix_cache = prefix_cache
        # two free queues, both O(1): plain pages first (nothing to lose),
        # then cached pages oldest-freed first (LRU eviction of the cache)
        self._free_plain: "OrderedDict[int, None]" = OrderedDict(
            (p, None) for p in range(n_pages))
        self._free_cached: "OrderedDict[int, None]" = OrderedDict()
        self._ref: Dict[int, int] = {}               # page -> refcount
        self._tables: Dict[int, List[int]] = {}      # req_id -> page list
        self._chains: Dict[int, List[bytes]] = {}    # req_id -> chain hashes
        # prefix index (published pages only)
        self._by_hash: Dict[bytes, int] = {}         # chain hash -> page
        self._hash_of: Dict[int, bytes] = {}         # page -> chain hash
        self._tokens: Dict[int, Tuple[int, ...]] = {}
        self._parent: Dict[int, Optional[bytes]] = {}
        self._children: Dict[Optional[bytes], "OrderedDict[int, None]"] = {}
        self.stats = PoolStats()

    # -- capacity --------------------------------------------------------
    @property
    def trash_page(self) -> int:
        """Device write target for padding/bubble rows; never allocatable."""
        return self.n_pages

    @property
    def in_use(self) -> int:
        return len(self._ref)

    @property
    def n_free(self) -> int:
        return len(self._free_plain) + len(self._free_cached)

    @property
    def n_seqs(self) -> int:
        return len(self._tables)

    def occupancy(self) -> float:
        return self.in_use / self.n_pages

    def note_tick(self) -> None:
        """Sample occupancy once per engine step (mean surfaces in stats)."""
        self.stats.occupancy_sum += self.occupancy()
        self.stats.occupancy_ticks += 1

    def table_of(self, req_id: int) -> Optional[List[int]]:
        """The request's page table (read-only view; mutate via the pool)."""
        return self._tables.get(req_id)

    def refcount(self, page: int) -> int:
        return self._ref.get(page, 0)

    def is_published(self, page: int) -> bool:
        return page in self._hash_of

    # -- free-list mechanics ---------------------------------------------
    def _take_free(self) -> Optional[int]:
        if self._free_plain:
            return self._free_plain.popitem(last=False)[0]
        if self._free_cached:
            # reuse the least-recently-freed cached page; its hash entry
            # dies with it (the cache is exactly the free-but-published set)
            page = self._free_cached.popitem(last=False)[0]
            self._unpublish(page)
            self.stats.cache_evictions += 1
            return page
        return None

    def _release(self, page: int) -> None:
        if page in self._hash_of:
            self._free_cached[page] = None
        else:
            self._free_plain[page] = None
        self.stats.frees += 1

    def _decref(self, page: int) -> None:
        self._ref[page] -= 1
        if self._ref[page] == 0:
            del self._ref[page]
            self._release(page)

    def _adopt(self, page: int) -> None:
        """Take one reference on a page; resurrects a cached-free page."""
        if page in self._ref:
            self._ref[page] += 1
            return
        # only published pages are discoverable, so a free adoptee must
        # sit in the cached queue
        del self._free_cached[page]
        self._ref[page] = 1

    def _unpublish(self, page: int) -> None:
        h = self._hash_of.pop(page)
        if self._by_hash.get(h) == page:
            del self._by_hash[h]
        parent = self._parent.pop(page)
        kids = self._children.get(parent)
        if kids is not None:
            kids.pop(page, None)
            if not kids:
                del self._children[parent]
        del self._tokens[page]

    # -- request lifecycle -----------------------------------------------
    def alloc_table(self, req_id: int) -> None:
        """Create an empty page table for an admitted request. Pages are
        allocated on write (:meth:`append_page`), never reserved."""
        if req_id in self._tables:
            raise ValueError(f"request {req_id} already holds a page table")
        self._tables[req_id] = []
        self._chains[req_id] = []
        self.stats.peak_seqs = max(self.stats.peak_seqs, len(self._tables))

    def free_table(self, req_id: int) -> List[int]:
        """Release every page reference the request holds (request done).
        Pages whose refcount drops to zero return to the free list but KEEP
        their hash entry until reused — the prefix cache outlives its
        publisher. Returns the released table."""
        if req_id not in self._tables:
            raise ValueError(f"request {req_id} holds no page table")
        table = self._tables.pop(req_id)
        del self._chains[req_id]
        for page in table:
            self._decref(page)
        return table

    def preempt(self, req_id: int) -> List[int]:
        """Evict a running request (the engine requeues it for a
        resume-prefill — which typically prefix-hits the victim's own
        still-cached pages). Same mechanics as :meth:`free_table`."""
        table = self.free_table(req_id)
        self.stats.preemptions += 1
        return table

    # -- prefix cache ----------------------------------------------------
    def match_prefix(self, tokens: Sequence[int],
                     max_rows: int) -> Tuple[List[int], int]:
        """Longest resident prefix of ``tokens`` (capped at ``max_rows``):
        whole pages via the chain-hash walk, then at most one partially
        matching published page (the tail). Pure query — no refcounts
        move; commit the result with :meth:`adopt_prefix`."""
        if not self.prefix_cache or max_rows <= 0:
            return [], 0
        ps = self.page_sz
        pages: List[int] = []
        rows = 0
        parent: Optional[bytes] = None
        while rows + ps <= max_rows:
            h = _chain_hash(parent, tokens[rows:rows + ps])
            page = self._by_hash.get(h)
            if page is None:
                break
            pages.append(page)
            rows += ps
            parent = h
        # partial tail: a published page continuing this exact prefix may
        # share its first rows even though the prompt diverges (or simply
        # ends) inside it
        best, best_n = None, 0
        for page in self._children.get(parent, ()):
            ptoks = self._tokens[page]
            lim = min(len(ptoks), max_rows - rows)
            n = 0
            while n < lim and int(ptoks[n]) == int(tokens[rows + n]):
                n += 1
            if n > best_n:
                best, best_n = page, n
        if best is not None:
            pages.append(best)
            rows += best_n
        return pages, rows

    def adopt_prefix(self, req_id: int, pages: Sequence[int],
                     rows: int) -> None:
        """Attach a :meth:`match_prefix` result to a fresh table: one ref
        per page; fully covered pages extend the request's publish chain
        (a partially covered tail does not — the request re-publishes its
        own version of that page once it completes it, after COW)."""
        table = self._tables[req_id]
        if table:
            raise ValueError(f"request {req_id} already holds pages")
        chain = self._chains[req_id]
        for page in pages:
            self._adopt(page)
            table.append(page)
        for page in pages[:rows // self.page_sz]:
            chain.append(self._hash_of[page])
        self.stats.prefix_hit_pages += len(pages)
        self.stats.prefix_hit_rows += rows
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)

    def publish_ready(self, req_id: int, tokens: Sequence[int],
                      committed: int) -> int:
        """Publish every fully committed, not-yet-published page of the
        request into the hash index (``tokens`` = the request's history;
        row ``i`` of the cache was written by ``tokens[i]``). Returns the
        number of pages newly published."""
        if not self.prefix_cache:
            return 0
        ps = self.page_sz
        table = self._tables[req_id]
        chain = self._chains[req_id]
        n_new = 0
        while (len(chain) + 1) * ps <= committed and len(chain) < len(table):
            idx = len(chain)
            page = table[idx]
            ptoks = tuple(int(t) for t in tokens[idx * ps:(idx + 1) * ps])
            parent = chain[-1] if chain else None
            h = _chain_hash(parent, ptoks)
            chain.append(h)
            if page in self._hash_of or h in self._by_hash:
                # page already published, or identical content resident on
                # another page — never alias one hash to two pages
                continue
            self._by_hash[h] = page
            self._hash_of[page] = h
            self._tokens[page] = ptoks
            self._parent[page] = parent
            self._children.setdefault(parent, OrderedDict())[page] = None
            self.stats.published += 1
            n_new += 1
        return n_new

    # -- page allocation / COW -------------------------------------------
    def append_page(self, req_id: int) -> Optional[int]:
        """Grow the request's table by one fresh page (alloc-on-write);
        None (counted) when the pool — including its cached-free reserve —
        is exhausted."""
        page = self._take_free()
        if page is None:
            self.stats.alloc_failures += 1
            return None
        self._ref[page] = 1
        self._tables[req_id].append(page)
        self.stats.allocs += 1
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)
        return page

    def ensure_writable(self, req_id: int,
                        idx: int) -> Tuple[str, Optional[Tuple[int, int]]]:
        """Make logical page ``idx`` of the request safe to write.

        * private & unpublished -> ``("ok", None)``: write in place.
        * private but published (sole owner of an adopted tail) ->
          ``("ok", None)``: the hash entry is dropped and the write goes
          in place — nobody else can be reading those rows.
        * shared (refcount > 1) -> copy-on-write: a fresh page replaces it
          in THIS table only; ``("cow", (src, dst))`` tells the engine to
          duplicate the device rows. The shared page is never mutated.
        * COW needed but the pool is exhausted -> ``("fail", None)``.
        """
        table = self._tables[req_id]
        page = table[idx]
        shared = self._ref[page] > 1
        published = page in self._hash_of
        chain = self._chains[req_id]
        if not shared:
            if published:
                self._unpublish(page)
                del chain[idx:]
            return "ok", None
        new = self._take_free()
        if new is None:
            self.stats.alloc_failures += 1
            return "fail", None
        self._ref[new] = 1
        self.stats.allocs += 1
        table[idx] = new
        self._decref(page)
        del chain[idx:]
        self.stats.cow_copies += 1
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)
        return "cow", (page, new)

    # -- invariants ------------------------------------------------------
    def check(self) -> None:
        """Assert the pool invariants (tests; cheap enough for debug use).
        Unlike the old slot pool's vacuous trash assertion, the trash-page
        checks here range over state that COULD contain it: every page
        table, both free queues, the refcounts and the hash index."""
        free_p, free_c = set(self._free_plain), set(self._free_cached)
        assert not (free_p & free_c), "page in both free queues"
        free = free_p | free_c
        ref = set(self._ref)
        assert not (free & ref), f"page both free and referenced: {free & ref}"
        assert free | ref == set(range(self.n_pages)), \
            "free + referenced must partition the pool"
        counts = Counter(p for t in self._tables.values() for p in t)
        assert self.trash_page not in counts, \
            "trash page leaked into a page table"
        assert self.trash_page not in free and self.trash_page not in ref, \
            "trash page leaked into the free list / refcounts"
        assert dict(counts) == self._ref, \
            f"refcounts != table membership: {dict(counts)} vs {self._ref}"
        for rid, t in self._tables.items():
            assert len(set(t)) == len(t), f"duplicate page in table {rid}"
            assert rid in self._chains and \
                len(self._chains[rid]) <= len(t)
        assert all(v > 0 for v in self._ref.values())
        # hash index consistency
        assert set(self._by_hash.values()) == set(self._hash_of), \
            "hash index and page->hash map disagree"
        for page, h in self._hash_of.items():
            assert self._by_hash[h] == page
            assert len(self._tokens[page]) == self.page_sz
            assert page in self._children[self._parent[page]]
        assert sum(len(k) for k in self._children.values()) \
            == len(self._hash_of)
        assert free_c <= set(self._hash_of), \
            "cached-free queue holds an unpublished page"
        assert self.stats.peak_in_use >= self.in_use
        assert self.stats.peak_seqs >= len(self._tables)

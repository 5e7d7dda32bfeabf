"""Refcounted free-list page allocator for the shared paged KV pool (port
of ``repro/serving/pages.py``).

The pool holds ``n_pages`` pages of ``page_size`` cache slots, shared by
every lane across all layers. With the prefix cache
(``serving/prefix_cache.py``) one page can back the same prompt prefix
in several lanes, so ownership is a refcount, and every page is in
exactly one of three states:

  * **free** — on the free list (refcount 0, not cached);
  * **referenced** — pinned by one or more lanes (refcount >= 1); the
    prefix cache may also hold it, which matters once the last lane
    lets go;
  * **cached-idle** — held only by the prefix cache (refcount 0 and
    cached): its K/V is valid and matchable, and LRU eviction turns it
    back into a free page under pressure.

``free + referenced + cached_idle == n_pages`` is checked after every
operation. Pages are handed out lowest index first and a released page
returns for immediate reuse, in the reference's order, so block tables
come out identical. Stale K/V in a reused page needs no zeroing: the
causal mask hides it through the block table. Releasing a page that no
lane holds raises instead of listing it twice (a double free would later
hand one page to two lanes).
"""
from __future__ import annotations

import numpy as np


class PagePool:
    """Host-side refcounted free list over ``n_pages`` pool pages."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"bad pool: {n_pages} pages of {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # stack, highest index at the bottom: alloc pops the lowest first
        self._free = list(range(n_pages - 1, -1, -1))
        self._rc = [0] * n_pages          # lane references per page
        self._cached = [False] * n_pages  # held by the prefix cache
        self._n_ref = 0                   # pages with rc > 0
        self._n_cached_idle = 0           # cached pages with rc == 0
        self.peak_in_use = 0
        # fault-injection port (serving/faults.py): called with the
        # request size at the top of alloc; True fails that allocation
        self.fault_hook = None
        # high-water of pages that lanes pin at once (shared pages count
        # once): what a pool sized for this traffic must provide
        self.peak_referenced = 0

    # ------------------------------------------------------------ queries
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        """Occupied pages (referenced + cached-idle)."""
        return self.n_pages - len(self._free)

    @property
    def referenced(self) -> int:
        return self._n_ref

    @property
    def cached_idle(self) -> int:
        return self._n_cached_idle

    @property
    def cached_pages(self) -> int:
        """Pages the prefix cache holds (idle or also lane-referenced)."""
        return sum(self._cached)

    def refcount(self, page: int) -> int:
        return self._rc[page]

    def exclusive(self, page: int) -> bool:
        """One lane holds the page and the prefix cache does not: its KV
        may go to the host and the page to another lane (preemption)."""
        return self._rc[page] == 1 and not self._cached[page]

    def is_cached(self, page: int) -> bool:
        return self._cached[page]

    def state(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(free list in pop order, refcount per page, cached flag per
        page): the whole accounting, for a digest."""
        return (np.asarray(self._free, np.int32),
                np.asarray(self._rc, np.int32),
                np.asarray(self._cached, bool))

    def _check(self) -> None:
        free, ref, ci = len(self._free), self._n_ref, self._n_cached_idle
        if free + ref + ci != self.n_pages:
            raise RuntimeError(
                f"page accounting broke: {free} free + {ref} referenced + "
                f"{ci} cached-idle != {self.n_pages}")

    def _valid(self, pages: list[int]) -> None:
        for p in pages:
            if not 0 <= p < self.n_pages:
                raise RuntimeError(f"page {p} outside a pool of "
                                   f"{self.n_pages}")

    # ---------------------------------------------------------- lifecycle
    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` free pages at refcount 1; raises RuntimeError when
        the free list cannot supply them (the admission gate makes that a
        bug)."""
        if self.fault_hook is not None and self.fault_hook(n):
            raise RuntimeError(
                f"injected page allocation failure ({n} pages)")
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: requested {n} pages, "
                f"{len(self._free)} free of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        self._n_ref += n
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        self.peak_referenced = max(self.peak_referenced, self._n_ref)
        self._check()
        return pages

    def retain(self, pages: list[int]) -> None:
        """One more lane reference per page. A cached-idle page becomes
        referenced (a prefix hit pins it); a free page cannot be
        retained."""
        self._valid(pages)
        for p in pages:
            if self._rc[p] == 0 and not self._cached[p]:
                raise RuntimeError(
                    f"retain of free page {p}: nothing owns it")
        for p in pages:
            if self._rc[p] == 0:            # cached-idle -> referenced
                self._n_ref += 1
                self._n_cached_idle -= 1
            self._rc[p] += 1
        self.peak_referenced = max(self.peak_referenced, self._n_ref)
        self._check()

    def release(self, pages: list[int]) -> None:
        """Drop one lane reference per page. The last reference frees the
        page, unless the prefix cache holds it: then it parks as
        cached-idle. Freed pages recycle lowest index first."""
        self._valid(pages)
        for p in pages:
            if self._rc[p] == 0:
                state = "cached-idle" if self._cached[p] else "free"
                raise RuntimeError(
                    f"double free of page {p}: it is already {state}")
        freed = []
        for p in pages:
            self._rc[p] -= 1
            if self._rc[p] == 0:
                self._n_ref -= 1
                if self._cached[p]:
                    self._n_cached_idle += 1
                else:
                    freed.append(p)
        self._free.extend(reversed(freed))
        self._check()

    # -------------------------------------------------------- prefix cache
    def cache_add(self, pages: list[int]) -> None:
        """The prefix cache takes shared ownership of ``pages``, while the
        donating lane still holds them (a page never transits the free
        list); once the lane releases, the page parks as cached-idle."""
        self._valid(pages)
        for p in pages:
            if self._rc[p] == 0 and not self._cached[p]:
                raise RuntimeError(
                    f"cache_add of free page {p}: donate before release")
        for p in pages:
            self._cached[p] = True
        self._check()

    def cache_drop(self, pages: list[int]) -> None:
        """Eviction: a cached page no lane references returns to the free
        list."""
        self._valid(pages)
        for p in pages:
            if not self._cached[p]:
                raise RuntimeError(f"cache_drop of uncached page {p}")
            if self._rc[p] > 0:
                raise RuntimeError(
                    f"cache_drop of page {p} still referenced by "
                    f"{self._rc[p]} lane(s)")
        for p in pages:
            self._cached[p] = False
            self._n_cached_idle -= 1
            self._free.append(p)
        self._check()

    def uncache(self, pages: list[int]) -> int:
        """Revoke the prefix cache's ownership whatever the references:
        an idle page frees now, a referenced one frees on its last
        release. Uncached entries are ignored. Returns the pages freed
        now."""
        self._valid(pages)
        freed = []
        for p in pages:
            if not self._cached[p]:
                continue
            self._cached[p] = False
            if self._rc[p] == 0:
                self._n_cached_idle -= 1
                freed.append(p)
        self._free.extend(freed)
        self._check()
        return len(freed)

    # ------------------------------------------------------------- helpers
    def reset_peaks(self) -> None:
        self.peak_in_use = self.in_use
        self.peak_referenced = self._n_ref

    def slots_for(self, n_slots: int) -> int:
        """Pages covering ``n_slots`` logical cache slots."""
        return -(-n_slots // self.page_size)

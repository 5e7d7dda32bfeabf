"""Free-list page allocator for the shared paged KV pool (port of
``repro/serving/pages.py`` without the prefix-cache states).

The pool holds ``n_pages`` pages of ``page_size`` cache slots, shared by
every lane across all layers. Pages are handed out lowest index first
and a released page returns for immediate reuse, in the reference's
order, so block tables come out identical. Stale K/V in a reused page
needs no zeroing: the causal mask hides it through the block table.
Releasing a page that is not owned raises instead of listing it twice
(a double free would later hand one page to two lanes).
"""
from __future__ import annotations


class PagePool:
    """Host-side free list over ``n_pages`` pool pages."""

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1 or page_size < 1:
            raise ValueError(f"bad pool: {n_pages} pages of {page_size}")
        self.n_pages = n_pages
        self.page_size = page_size
        # stack, highest index at the bottom: alloc pops the lowest first
        self._free = list(range(n_pages - 1, -1, -1))
        self._owned = [False] * n_pages
        self.peak_in_use = 0

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.n_pages - len(self._free)

    def alloc(self, n: int) -> list[int]:
        """Pop ``n`` free pages; raises RuntimeError when the free list
        cannot supply them (the admission gate makes that a bug)."""
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: requested {n} pages, "
                f"{len(self._free)} free of {self.n_pages}")
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._owned[p] = True
        self.peak_in_use = max(self.peak_in_use, self.in_use)
        return pages

    def release(self, pages: list[int]) -> None:
        """Return owned pages to the free list (recycled low-index-first,
        as the reference does)."""
        for p in pages:
            if not 0 <= p < self.n_pages or not self._owned[p]:
                raise RuntimeError(f"double free of page {p}")
        for p in pages:
            self._owned[p] = False
        self._free.extend(reversed(pages))

    def reset_peaks(self) -> None:
        self.peak_in_use = self.in_use

    def slots_for(self, n_slots: int) -> int:
        """Pages covering ``n_slots`` logical cache slots."""
        return -(-n_slots // self.page_size)

"""Radix-tree prefix cache: refcounted copy-on-write sharing of KV pages
(port of ``repro/serving/prefix_cache.py``).

A host-side radix tree over token IDs whose nodes own pool pages. At
admission a request's longest cached prefix is matched and the shared
pages go straight into its block table (no prefill compute and no K/V
writes for them); only the uncovered tail is prefilled.

The tree is page-chunked, so a page is never split across nodes:

  * an **edge** is a run of full ``page_size``-token chunks, one pool
    page each; edges split only at page boundaries;
  * a node also carries **tails**: partly filled boundary pages. A
    sequence that ends mid-page parks its last ``1..page_size-1`` tokens
    there. A request may match into a tail (or part way into an edge's
    page), but since it goes on writing that page the engine copies it
    first (copy-on-write): a page with refcount > 1 is never written.

Sharing is positional: a page caches K/V roped at the canonical
positions ``[j*page_size, (j+1)*page_size)``, so it serves only lanes at
``offset == 0``, which is how the engine admits prefix-cached requests.

Lifecycle against the pool's page states (``serving/pages.py``):
``match`` is a lookup (the engine ``retain``s the result before anything
can evict it); ``insert`` runs when a request finishes, before its lane
releases its pages, and donates the pages the tree does not hold yet;
``evict`` frees cold, unreferenced tails and leaf-edge suffixes, least
recently used first. The tree holds no tensor data.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.serving.pages import PagePool


@dataclasses.dataclass
class Match:
    """A prefix lookup's result. ``pages`` are fully valid shared pages
    covering slots ``[0, len(pages) * page_size)``; ``tail_page`` is a
    boundary page whose first ``tail_matched`` rows continue the prefix
    (the lane copies it before writing). ``matched_tokens`` counts both
    and is always below the prompt length."""
    pages: list[int]
    matched_tokens: int
    tail_page: int | None = None
    tail_matched: int = 0


@dataclasses.dataclass
class _Tail:
    tokens: tuple          # 1..page_size-1 tokens past the node's chunks
    page: int              # pool page; rows [0, len(tokens)) are valid
    last_access: int


class _Node:
    __slots__ = ("edge", "pages", "children", "tails", "parent",
                 "last_access")

    def __init__(self, edge, pages, parent, clock=0):
        self.edge: list[tuple] = edge      # full page_size-token chunks
        self.pages: list[int] = pages      # one pool page per chunk
        self.children: dict[tuple, _Node] = {}
        self.tails: list[_Tail] = []
        self.parent: _Node | None = parent
        self.last_access = clock


class PrefixCache:
    """Host-side radix tree mapping token prefixes to pool pages."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.page_size = pool.page_size
        self.root = _Node([], [], None)
        self._clock = 0

    # ------------------------------------------------------------- lookup
    def reclaimable(self) -> int:
        """Pages eviction could free now: every cached-idle page (lanes
        pin root-path prefixes, so an idle page's subtree is idle and
        leaf-first eviction reaches it)."""
        return self.pool.cached_idle

    def match(self, tokens: np.ndarray) -> Match:
        """Longest cached prefix of ``tokens``, capped at ``len - 1`` so
        the tail prefill runs at least one token (the engine needs the
        last token's logits). A lookup apart from the LRU touch."""
        self._clock += 1
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        cap = len(toks) - 1
        ps = self.page_size

        def common(cached_toks):
            t = 0
            for a, b in zip(cached_toks, toks[depth:cap]):
                if a != b:
                    break
                t += 1
            return t

        pages: list[int] = []
        node = self.root
        depth = 0
        tail_page, tail_matched = None, 0
        while depth + ps <= cap:
            child = node.children.get(tuple(toks[depth:depth + ps]))
            if child is None:
                break
            child.last_access = self._clock
            i = 0
            while (i < len(child.edge) and depth + ps <= cap
                   and tuple(toks[depth:depth + ps]) == child.edge[i]):
                pages.append(child.pages[i])
                depth += ps
                i += 1
            if i < len(child.edge):
                # stopped inside the edge (the cap, or a divergence
                # mid-page): the next page continues the prompt only in
                # its first rows, a copy-on-write boundary like a tail
                t = common(child.edge[i])
                if t:
                    tail_page, tail_matched = child.pages[i], t
                return Match(pages, depth + tail_matched, tail_page,
                             tail_matched)
            node = child
        # at a node boundary: the best partial continuation among the
        # node's tails and its children's first pages
        best = None
        for tail in node.tails:
            t = common(tail.tokens)
            if t > tail_matched:
                tail_matched, tail_page, best = t, tail.page, tail
        for child in node.children.values():
            t = common(child.edge[0])
            if t > tail_matched:
                tail_matched, tail_page, best = t, child.pages[0], child
        if best is not None:
            best.last_access = self._clock
        return Match(pages, depth + tail_matched, tail_page, tail_matched)

    # ------------------------------------------------------------- insert
    def insert(self, tokens: np.ndarray, pages: list[int]) -> int:
        """Insert a finished sequence: ``tokens`` are the tokens whose
        K/V the lane wrote, ``pages`` its pages covering them in logical
        order. Pages backing chunks the tree lacks are donated
        (``cache_add``); coverage the tree already has is not, and the
        lane's copy frees on release. Returns the pages donated."""
        self._clock += 1
        toks = [int(t) for t in np.asarray(tokens).reshape(-1)]
        ps = self.page_size
        chunks = [tuple(toks[j * ps:(j + 1) * ps])
                  for j in range(len(toks) // ps)]
        if len(pages) < -(-len(toks) // ps):
            raise ValueError(f"{len(pages)} pages do not cover "
                             f"{len(toks)} tokens")
        node, i, donated = self.root, 0, 0
        node.last_access = self._clock
        while i < len(chunks):
            child = node.children.get(chunks[i])
            if child is None:
                donate = list(pages[i:len(chunks)])
                self.pool.cache_add(donate)
                donated += len(donate)
                leaf = _Node(list(chunks[i:]), donate, node, self._clock)
                node.children[chunks[i]] = leaf
                node = leaf
                i = len(chunks)
                break
            child.last_access = self._clock
            k = 0
            while (k < len(child.edge) and i + k < len(chunks)
                   and child.edge[k] == chunks[i + k]):
                k += 1
            if k < len(child.edge):
                # split at the page boundary after k matched chunks; the
                # lower half keeps the children and tails
                mid = _Node(child.edge[:k], child.pages[:k], node,
                            self._clock)
                mid.children[child.edge[k]] = child
                child.edge = child.edge[k:]
                child.pages = child.pages[k:]
                child.parent = mid
                node.children[mid.edge[0]] = mid
                node = mid
            else:
                node = child
            i += k
        rest = tuple(toks[len(chunks) * ps:])
        if rest:
            t = len(rest)
            covered = any(tail.tokens[:t] == rest for tail in node.tails)
            if not covered:
                page = pages[len(chunks)]
                self.pool.cache_add([page])
                donated += 1
                node.tails.append(_Tail(rest, page, self._clock))
        return donated

    # ------------------------------------------------------------ eviction
    def evict(self, need: int) -> int:
        """Free at least ``need`` pages by dropping cold entries, least
        recently used first: unreferenced tails, then unreferenced
        suffixes of leaf edges (an emptied leaf detaches and may expose
        its parent). Referenced pages are untouchable. Returns the pages
        freed (fewer than ``need`` when nothing idle is left)."""
        freed = 0
        progress = True
        while freed < need and progress:
            # one pass collects every candidate, dropped in LRU order; the
            # outer loop scans again only when a detached leaf may have
            # exposed its parent and more pages are needed
            progress = False
            cands: list[tuple[int, int, _Node, _Tail | None]] = []
            stack = [self.root]
            while stack:
                nd = stack.pop()
                stack.extend(nd.children.values())
                for tail in nd.tails:
                    if self.pool.refcount(tail.page) == 0:
                        cands.append((tail.last_access, 1, nd, tail))
                if (nd.parent is not None and not nd.children
                        and not nd.tails
                        and self.pool.refcount(nd.pages[-1]) == 0):
                    cands.append((nd.last_access, 0, nd, None))
            for _, kind, nd, tail in sorted(cands, key=lambda c: c[:2]):
                if freed >= need:
                    break
                if kind == 1:
                    nd.tails.remove(tail)
                    self.pool.cache_drop([tail.page])
                    freed += 1
                    progress = True
                    continue
                key = nd.edge[0]
                while (nd.edge and freed < need
                       and self.pool.refcount(nd.pages[-1]) == 0):
                    nd.edge.pop()
                    self.pool.cache_drop([nd.pages.pop()])
                    freed += 1
                    progress = True
                if not nd.edge:
                    del nd.parent.children[key]
                    nd.parent = None
        return freed

    def flush(self) -> int:
        """Drop every cached entry: referenced pages lose their cached
        flag and free on their last release. Returns the pages dropped
        from the tree."""
        pages: list[int] = []
        stack = [self.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            pages.extend(nd.pages)
            pages.extend(t.page for t in nd.tails)
        self.pool.uncache(pages)
        self.root = _Node([], [], None)
        return len(pages)

    def __len__(self) -> int:
        """Cached pages the tree holds."""
        n = 0
        stack = [self.root]
        while stack:
            nd = stack.pop()
            stack.extend(nd.children.values())
            n += len(nd.pages) + len(nd.tails)
        return n

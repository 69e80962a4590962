"""The paged engine's page allocator and radix prefix index — the port
of ``tpudp/serve/prefix_cache.py``'s ``_Node``, ``PagePool`` and
``PageIndex``.

Host-side bookkeeping is plain Python with the JAX package's allocation
order, refcount discipline and eviction order, so identical operation
sequences give identical page ids; the one device object is the pool
buffer, a :class:`KVCache` (or, with ``kv_dtype="int8"``, an
:class:`Int8Pages`) of torch tensors on the engine's device.
The dense copy cache (``PrefixCache``, ``copy_block_in/out``) is not
ported: the port's engine reuses prefixes through the page tables.
"""

from __future__ import annotations

from tpudp_torch.models.generate import Int8Pages, KVCache


class _Node:
    """One radix-tree edge: ``key`` (the chunk's token tuple) maps — in
    the context of ``parent``'s prefix — to pool page ``block``.
    ``refs`` counts children plus explicit pins; ``stamp`` is the
    logical-clock LRU touch."""

    __slots__ = ("key", "block", "parent", "children", "refs", "stamp")

    def __init__(self, key, block, parent):
        self.key = key
        self.block = block
        self.parent = parent
        self.children = {}
        self.refs = 0
        self.stamp = 0


class PagePool:
    """Refcounted KV page pool: ``num_pages`` real pages plus one
    trailing scratch page (index ``num_pages``) that absorbs masked
    writes.  A page is free (on the free list) or allocated (rc >= 1);
    ``alloc`` hands out rc=1, every extra holder ``share``s, every holder
    ``release``s, and rc 0 returns the page to the free list.
    ``kv_dtype="int8"`` stores the payloads quantized (:class:`Int8Pages`)
    with the same page ids and allocation order."""

    def __init__(self, cfg, num_pages: int, page_tokens: int,
                 device="cpu", kv_dtype: str | None = None):
        if num_pages < 1:
            raise ValueError(f"num_pages must be >= 1, got {num_pages}")
        if page_tokens < 1:
            raise ValueError(
                f"page_tokens must be >= 1, got {page_tokens}")
        if kv_dtype not in (None, "int8"):
            raise ValueError(
                f"kv_dtype must be None or 'int8', got {kv_dtype!r}")
        self.config = cfg
        self.num_pages = num_pages
        self.page_tokens = page_tokens
        self.kv_dtype = kv_dtype
        self.scratch = num_pages
        cls = Int8Pages if kv_dtype == "int8" else KVCache
        self.pages = cls.zeros(cfg, num_pages + 1, page_tokens, device)
        self._rc: dict[int, int] = {}
        self._free = list(range(num_pages - 1, -1, -1))

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def page_bytes(self) -> int:
        """Device bytes of one page across k and v (and their scales in
        int8 mode)."""
        total = sum(buf.numel() * buf.element_size() for buf in self.pages)
        return total // (self.num_pages + 1)

    def alloc(self) -> int | None:
        """One exclusive page (rc=1), or None when the pool is empty."""
        if not self._free:
            return None
        page = self._free.pop()
        self._rc[page] = 1
        return page

    def share(self, page: int) -> None:
        self._rc[page] += 1

    def release(self, page: int) -> None:
        rc = self._rc[page] - 1
        if rc:
            self._rc[page] = rc
        else:
            del self._rc[page]
            self._free.append(page)

    def reset(self) -> None:
        """Every page freed and every buffer back to a fresh pool's values
        (zeros, int8 scales 1), in place: the engine's step-failure
        containment.  The buffers keep their addresses, which captured
        CUDA graphs hold (JAX reallocates instead)."""
        for name, buf in zip(self.pages._fields, self.pages):
            buf.fill_(1 if name.endswith("_scale") else 0)
        self._rc = {}
        self._free = list(range(self.num_pages - 1, -1, -1))

    def check(self, expected_refs: dict[int, int] | None = None) -> None:
        """Pool consistency; with ``expected_refs`` (page -> holders from
        the live tables and trees) also the table<->pool cross-check."""
        if set(self._rc) & set(self._free):
            raise RuntimeError("pages both allocated and free")
        if len(self._rc) + len(self._free) != self.num_pages:
            raise RuntimeError(
                f"{len(self._rc)} allocated + {len(self._free)} free != "
                f"{self.num_pages} total")
        for page, rc in self._rc.items():
            if not 0 <= page < self.num_pages:
                raise RuntimeError(f"out-of-range page {page} allocated")
            if rc < 1:
                raise RuntimeError(f"page {page} held at rc {rc}")
        if expected_refs is not None and dict(self._rc) != expected_refs:
            raise RuntimeError(
                f"pool refcounts {dict(sorted(self._rc.items()))} "
                f"disagree with table/tree holders "
                f"{dict(sorted(expected_refs.items()))}")


class PageIndex:
    """Radix tree over token prefixes whose nodes own pool pages.  A node
    holds one pool reference on its page; slots mapping a cached page
    pin the node and take their own reference.  Publishing adopts a
    retiring slot's pages instead of copying KV; eviction releases cold
    unreferenced leaves under allocation pressure."""

    def __init__(self, pool: PagePool):
        self.pool = pool
        self.block_tokens = pool.page_tokens
        self.evictions = 0
        self._root = _Node(None, -1, None)
        self._by_block: dict[int, _Node] = {}
        self._clock = 0

    def reset(self) -> None:
        """Forget every node, holding no page (the pool was reset)."""
        self._root = _Node(None, -1, None)
        self._by_block = {}

    @property
    def node_count(self) -> int:
        return len(self._by_block)

    def _touch(self, node: _Node) -> None:
        self._clock += 1
        node.stamp = self._clock

    def _chunk_key(self, tokens, i: int) -> tuple:
        c = self.block_tokens
        return tuple(int(t) for t in tokens[i * c:(i + 1) * c])

    def lookup(self, tokens) -> list[_Node]:
        """Nodes covering the longest cached block-aligned prefix of
        ``tokens``, each touched so reused prefixes stay warm."""
        out: list[_Node] = []
        cur = self._root
        for i in range(len(tokens) // self.block_tokens):
            nxt = cur.children.get(self._chunk_key(tokens, i))
            if nxt is None:
                break
            self._touch(nxt)
            out.append(nxt)
            cur = nxt
        return out

    def pin(self, node: _Node) -> None:
        node.refs += 1

    def unpin(self, node: _Node) -> None:
        node.refs -= 1

    def adopt(self, tokens, pages: list[int]) -> int:
        """Insert-or-ref the first ``len(pages)`` chunks of ``tokens``; a
        new node takes its own pool reference on the caller's page.
        Returns the number of newly adopted pages."""
        new = 0
        cur = self._root
        for i, page in enumerate(pages):
            key = self._chunk_key(tokens, i)
            nxt = cur.children.get(key)
            if nxt is None:
                nxt = _Node(key, page, cur)
                cur.children[key] = nxt
                cur.refs += 1
                self._by_block[page] = nxt
                self.pool.share(page)
                new += 1
            self._touch(nxt)
            cur = nxt
        return new

    def evict_node(self, node: _Node) -> None:
        """Unlink one unreferenced leaf and release its page."""
        del node.parent.children[node.key]
        node.parent.refs -= 1
        del self._by_block[node.block]
        self.pool.release(node.block)
        self.evictions += 1

    def evict_one(self) -> bool:
        """Release the least-recently-touched unreferenced leaf's page
        (False when every node is referenced)."""
        victim = None
        for node in self._by_block.values():
            if node.refs:
                continue
            if victim is None or node.stamp < victim.stamp:
                victim = node
        if victim is None:
            return False
        self.evict_node(victim)
        return True

    def tree_refs(self) -> dict[int, int]:
        """page -> pool references held by this tree (1 per node)."""
        return {page: 1 for page in self._by_block}

    def check(self) -> None:
        """Tree-shape invariants: refs cover children, links agree, every
        node owns one in-range page and no page has two owners."""
        seen: dict[int, _Node] = {}
        stack = [self._root]
        while stack:
            node = stack.pop()
            if node.refs < len(node.children):
                raise RuntimeError(
                    f"node {node.key!r} refs {node.refs} below child "
                    f"count {len(node.children)}")
            for key, child in node.children.items():
                if child.parent is not node or child.key != key:
                    raise RuntimeError(
                        f"child {key!r} has inconsistent parent/key links")
                if not 0 <= child.block < self.pool.num_pages:
                    raise RuntimeError(
                        f"node {key!r} owns out-of-range page "
                        f"{child.block}")
                if child.block in seen:
                    raise RuntimeError(
                        f"page {child.block} owned by two nodes")
                seen[child.block] = child
                stack.append(child)
        if set(seen) != set(self._by_block):
            raise RuntimeError("page index disagrees with the tree")

"""Radix prefix cache over the paged KV pool (a copy of
repro/serving/prefix.py, so that this package imports nothing from repro —
importing ``repro.serving.prefix`` would run ``repro/serving/__init__.py``,
which imports the JAX engine; the telemetry counters come with ROADMAP A6).

Host-side bookkeeping for serving/kvcache.py's paged pool: a radix tree
over token-block keys plus a free list of physical blocks. The engine asks
three questions per request —

  match    which cached blocks cover this prompt's longest prefix?
           (block-granular: an edge is one full block of tokens, so a
           match length is always a multiple of block_size; mid-block
           overlap re-prefills from the last block boundary)
  alloc    give me N physical blocks for the un-cached suffix + decode
           growth (evicting refcount-0 LRU leaves under pressure)
  publish  this block is full and its content is now immutable — hang it
           on the tree so later prompts can share it

Every physical block is in exactly one of three states: *free* (on the
allocator's list), *tree-owned* (a node holds it; ``ref`` counts the slots
currently reading it, 0 = evictable), or *request-private* (allocated to a
slot, not yet published). K/V blocks are position-dependent (RoPE is baked
in before insert) but a block's position equals its depth in the tree
times block_size, so content-addressing by token path is exact: two
requests whose prompts share the first k·bs tokens produce bit-identical
blocks for pages 0..k-1 and may share the physical storage.

Pure Python, no torch: fully unit-testable without a model, and everything
here is O(prompt / block_size) per request against pools of at most a few
thousand blocks.
"""

from __future__ import annotations


class RadixNode:
    """One published block: ``tokens`` is the full-block token tuple
    labelling the edge from ``parent``, ``block`` the physical id."""

    __slots__ = ("tokens", "block", "parent", "children", "ref", "last_use")

    def __init__(self, tokens, block, parent):
        self.tokens = tokens
        self.block = block
        self.parent = parent
        self.children: dict[tuple, RadixNode] = {}
        self.ref = 0
        self.last_use = 0

    def depth_tokens(self) -> int:
        n, node = 0, self
        while node.parent is not None:
            n += len(node.tokens)
            node = node.parent
        return n


class PrefixPool:
    """Block allocator + radix tree over ``n_blocks`` physical blocks."""

    def __init__(self, n_blocks: int, block_size: int):
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.free: list[int] = list(range(n_blocks))
        self.root = RadixNode((), -1, None)      # sentinel, never evicted
        self.stats = {"hits": 0, "hit_tokens": 0, "evicted_blocks": 0,
                      "published_blocks": 0}

    # -- queries ------------------------------------------------------------

    def match(self, tokens, *, clock: int = 0) -> list[RadixNode]:
        """Longest cached chain of full blocks prefixing ``tokens``, capped
        one token short of the full prompt (a fully-cached prompt must
        still prefill >= 1 token to produce its first logits). Bumps
        last_use along the chain; does NOT take refs — call acquire()."""
        bs = self.block_size
        node, chain = self.root, []
        limit = (len(tokens) - 1) // bs          # cap: suffix stays non-empty
        for i in range(limit):
            child = node.children.get(tuple(int(t) for t in
                                            tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            child.last_use = clock
            chain.append(child)
            node = child
        return chain

    def acquire(self, nodes):
        """Take one ref per node (a request starts reading the chain).
        No stats here: acquire/release also pin candidate chains across an
        admission wave's allocations, so a deferred request may cycle
        through several acquires — the engine calls record_hit() exactly
        once, when a request is finally admitted through its chain."""
        for n in nodes:
            n.ref += 1

    def release(self, nodes):
        for n in nodes:
            n.ref -= 1
            assert n.ref >= 0, "refcount underflow"

    def record_hit(self, nodes):
        """Count one admitted prefix hit (called once per admitted
        request whose matched chain is non-empty)."""
        if nodes:
            self.stats["hits"] += 1
            self.stats["hit_tokens"] += sum(len(n.tokens) for n in nodes)

    # -- allocation / eviction ---------------------------------------------

    def evictable_blocks(self) -> int:
        return len(self.free) + sum(1 for n in self._walk()
                                    if n.ref == 0 and not n.children)

    def alloc(self, n: int, *, clock: int = 0) -> list[int] | None:
        """Pop n free blocks, evicting refcount-0 LRU leaves as needed.
        Returns None (allocating nothing) if the pool cannot satisfy the
        request even after evicting everything evictable."""
        while len(self.free) < n:
            victim = None
            for node in self._walk():
                if node.ref == 0 and not node.children:
                    if victim is None or node.last_use < victim.last_use:
                        victim = node
            if victim is None:
                return None
            self._drop(victim)
        got, self.free = self.free[:n], self.free[n:]
        return got

    def free_blocks(self, blocks):
        self.free.extend(blocks)

    # -- publishing ---------------------------------------------------------

    def publish(self, parent: RadixNode | None, tokens, block: int,
                *, clock: int = 0) -> tuple[RadixNode, bool]:
        """Publish one full block under ``parent`` (None = root).

        Returns (node, owned): ``owned`` is True when the tree took
        ownership of ``block`` (the caller keeps a ref via the node, and
        must stop treating the block as private); False when an identical
        block was already published — the returned existing node carries
        the caller's new ref, and the caller keeps its duplicate private
        block (same content, freed at request end).
        """
        parent = parent or self.root
        key = tuple(int(t) for t in tokens)
        assert len(key) == self.block_size
        child = parent.children.get(key)
        if child is not None:
            child.ref += 1
            child.last_use = clock
            return child, False
        node = RadixNode(key, block, parent)
        node.ref = 1
        node.last_use = clock
        parent.children[key] = node
        self.stats["published_blocks"] += 1
        return node, True

    # -- internals ----------------------------------------------------------

    def _walk(self):
        stack = list(self.root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            yield node

    def _drop(self, node: RadixNode):
        del node.parent.children[node.tokens]
        self.free.append(node.block)
        self.stats["evicted_blocks"] += 1

    def tree_blocks(self) -> int:
        return sum(1 for _ in self._walk())

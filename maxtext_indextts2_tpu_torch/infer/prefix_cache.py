"""Prompt prefix caching for the serving engine.

Counterpart of the JAX package's ``infer/prefix_cache.py``. Requests that
share a long prefix (a system prompt, a voice prompt's codes) skip prefilling
the shared part again: KV snapshots at chunk boundaries are kept, keyed by
the exact prefix tokens, and ``Engine.prefill_cached`` resumes its chunked
prefill from the longest hit. Entries are stored at chunk boundaries only,
as in the JAX package (there so that every resumed prefill reuses one
compiled chunk program).

The class is the JAX package's, line for line
(``tests/test_torch_port_hygiene.py`` holds it so). A snapshot (its "KV
cache pytree") is the prefix's cache rows COPIED out of the prefill (per
unit a list of batch-1 ``KVCache`` s of exactly ``offset`` rows: keys,
values, and the int8 scales where the cache is quantized), owned by this
cache and aliased to no live prefix or slot: at ``tts-1b`` (20 layers, 8 kv heads of 128, bfloat16)
a 1,024-token snapshot holds 20 x 2 x 1024 x 8 x 128 x 2 bytes = 80 MiB.
"""

from __future__ import annotations

from collections import OrderedDict


class PrefixCache:
    """LRU store: prefix tokens (chunk-aligned) -> KV cache pytree."""

    def __init__(self, chunk_size: int, max_entries: int = 16):
        self.chunk_size = chunk_size
        self.max_entries = max_entries
        self._store: OrderedDict[tuple, dict] = OrderedDict()
        self.hits = 0
        self.misses = 0

    def lookup(self, tokens, true_length: int):
        """Longest chunk-aligned strict prefix with a cached snapshot.

        Returns (offset, cache) or (0, None). Strict: at least one token of
        the prompt is left to prefill so the next-token logits are fresh."""
        best = 0
        cache = None
        limit = true_length - 1
        for off in range(self.chunk_size, limit + 1, self.chunk_size):
            key = tuple(int(t) for t in tokens[:off])
            entry = self._store.get(key)
            if entry is None:
                continue
            best, cache = off, entry
            self._store.move_to_end(key)
        if cache is None:
            self.misses += 1
        else:
            self.hits += 1
        return best, cache

    def insert(self, tokens, offset: int, cache) -> None:
        """Store the KV snapshot covering tokens[:offset] (chunk-aligned)."""
        if offset % self.chunk_size != 0 or offset == 0:
            return
        key = tuple(int(t) for t in tokens[:offset])
        self._store[key] = cache
        self._store.move_to_end(key)
        while len(self._store) > self.max_entries:
            self._store.popitem(last=False)

    def stats(self) -> dict:
        return {
            "entries": len(self._store),
            "hits": self.hits,
            "misses": self.misses,
        }

"""Paged KV cache and the gather route of paged decode attention.

Counterpart of the JAX package's ``infer/paged_attention.py``. A layer's
cache is a pool of pages ``[num_pages, tokens_per_page, n_kv, d]``; which
pages a slot owns is the :class:`~maxtext_indextts2_tpu_torch.infer.page_manager.PageState`
that every layer shares. Row ``r`` of slot ``b`` lies at page
``page_map[b, r // tokens_per_page]``, offset ``r % tokens_per_page``.

The writes are plain indexed assignments IN PLACE (the JAX package's are
XLA scatters returning new pools), at rows worked out ONCE for every layer:
:func:`prefill_rows` once an insert, :func:`paged_decode_step` once a decode
step (eager PyTorch launches each small op of it, per layer it would be ~180
more launches a step at 20 layers). :func:`write_prefill` takes a prompt of
any length and writes its rows only: nothing is padded, so no padded page is
written and the null page never is. :func:`paged_decode_attention` is the
route the JAX model takes off the TPU or with a logit soft cap: gather every
slot's pages into a contiguous ``[slots, max_pages * tpp, n_kv, d]`` view
and run masked dot-product attention. On a CUDA tensor without a soft cap
the model takes the K4 kernel (``ops/ragged_decode_attention.paged_decode_attention_v2``)
instead, which reads each valid row once through the page map.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from maxtext_indextts2_tpu_torch.infer.page_manager import PageState


class PagedKVCache:
    """One layer's page pools, updated in place."""

    def __init__(self, key_pages: torch.Tensor, value_pages: torch.Tensor):
        self.key_pages = key_pages  # [num_pages, tokens_per_page, n_kv, d]
        self.value_pages = value_pages

    @property
    def tokens_per_page(self) -> int:
        return self.key_pages.shape[1]

    def clone(self) -> "PagedKVCache":
        return PagedKVCache(self.key_pages.clone(), self.value_pages.clone())


def init_paged_cache(num_pages: int, tokens_per_page: int, n_kv: int, d: int,
                     dtype=torch.bfloat16, device=None) -> PagedKVCache:
    shape = (num_pages, tokens_per_page, n_kv, d)
    return PagedKVCache(torch.zeros(shape, dtype=dtype, device=device),
                        torch.zeros(shape, dtype=dtype, device=device))


def _flat(pages: torch.Tensor) -> torch.Tensor:
    """[num_pages * tpp, n_kv, d] view of a pool: one row per cache row."""
    return pages.view(-1, *pages.shape[2:])


def write_rows(cache: PagedKVCache, rows: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               live: torch.Tensor | None = None) -> PagedKVCache:
    """k, v: [n, n_kv, d] written at flat pool rows ``rows`` [n]; where
    ``live`` ([n, 1, 1] bool) is False the row's old value is written back.
    In place; returns ``cache``."""
    for pool, new in ((cache.key_pages, k), (cache.value_pages, v)):
        flat = _flat(pool)
        new = new.to(pool.dtype)
        flat[rows] = new if live is None else torch.where(live, new, flat[rows])
    return cache


def prefill_rows(page_ids: torch.Tensor, length: int, tokens_per_page: int) -> torch.Tensor:
    """Flat pool rows of a prompt's rows 0..length-1: row r at page
    ``page_ids[r // tpp]``, offset ``r % tpp``."""
    r = torch.arange(length, device=page_ids.device)
    return page_ids.long()[r // tokens_per_page] * tokens_per_page + r % tokens_per_page


def write_prefill(cache: PagedKVCache, page_ids: torch.Tensor, k: torch.Tensor,
                  v: torch.Tensor) -> PagedKVCache:
    """k, v: [1, P, n_kv, d] prefill keys/values, any P. In place; returns ``cache``."""
    return write_rows(cache, prefill_rows(page_ids, k.shape[1], cache.tokens_per_page),
                      k[0], v[0])


class PagedDecodeStep(NamedTuple):
    """What every layer of one paged decode step reads, worked out once."""
    page_state: PageState
    rows: torch.Tensor  # [num_slots] flat pool row of each slot's new token
    live: torch.Tensor  # [num_slots, 1, 1] bool: the slot holds tokens


def paged_decode_step(state: PageState, tokens_per_page: int) -> PagedDecodeStep:
    """Each slot writes its new token at row ``seq_lens - 1``
    (``allocate_decode_step`` advanced ``seq_lens`` before the model call)."""
    pos = torch.clamp(state.seq_lens - 1, min=0).long()
    slots = torch.arange(pos.shape[0], device=pos.device)
    rows = state.page_map[slots, pos // tokens_per_page].long() * tokens_per_page \
        + pos % tokens_per_page
    return PagedDecodeStep(state, rows, (state.seq_lens > 0)[:, None, None])


def write_decode_step(cache: PagedKVCache, state: PageState, k: torch.Tensor,
                      v: torch.Tensor) -> PagedKVCache:
    """k, v: [num_slots, 1, n_kv, d]: each slot's new token at row
    ``seq_lens - 1``. A slot that holds nothing (``seq_lens == 0``) writes its
    row's old value back, as the JAX function does. In place; returns ``cache``."""
    step = paged_decode_step(state, cache.tokens_per_page)
    return write_rows(cache, step.rows, k[:, 0], v[:, 0], step.live)


def paged_decode_attention(q: torch.Tensor, cache: PagedKVCache, state: PageState,
                           logits_soft_cap: float = 0.0,
                           float32_qk: bool = True) -> torch.Tensor:
    """q: [num_slots, 1, n_q, d]. Gather each slot's pages to a contiguous
    view and attend over its first ``seq_lens`` rows. Returns [num_slots, 1, n_q, d]."""
    from maxtext_indextts2_tpu_torch.models.attention import dot_product_attention

    tpp = cache.tokens_per_page
    num_slots, max_pages = state.page_map.shape
    pm = state.page_map.long()
    k = cache.key_pages[pm].reshape(num_slots, max_pages * tpp, *cache.key_pages.shape[2:])
    v = cache.value_pages[pm].reshape(num_slots, max_pages * tpp, *cache.value_pages.shape[2:])
    valid = torch.arange(max_pages * tpp, device=q.device)[None, :] < state.seq_lens[:, None]
    return dot_product_attention(q, k, v, valid[:, None, None, :], logits_soft_cap, float32_qk)

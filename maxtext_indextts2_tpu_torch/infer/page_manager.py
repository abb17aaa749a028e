"""Page manager of the paged KV cache: which pool page holds which slot's rows.

Counterpart of the JAX package's ``infer/page_manager.py``. The state is
three int32 tensors on the device:

- ``page_status``: [num_pages] 1 = in use. Page 0 is the reserved null page,
  so a zero-initialised ``page_map`` points at it.
- ``page_map``: [num_slots, max_pages_per_slot] page ids of each slot.
- ``seq_lens``: [num_slots] tokens held by each slot.

Every function returns a new :class:`PageState` and hands out exactly the
pages the JAX functions hand out: the r-th page asked for is the r-th free
page in page order. Each is a fixed number of tensor ops with no
device-to-host copy, so a decode step that calls :func:`allocate_decode_step`
stays free of synchronisation.

Where this differs from the JAX package, on purpose: :func:`allocate_decode_step`
SATURATES a slot at ``max_pages_per_slot * tokens_per_page`` tokens. The JAX
function advances ``seq_lens`` without a bound and grows the page map past
its last column, which XLA clamps or drops silently; on CUDA an index past
the map is a device-side fault that ends the context for the whole process.
A saturated slot takes no page and its length stays put.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class PageState(NamedTuple):
    page_status: torch.Tensor  # [num_pages] int32, 1 = in use (page 0 reserved)
    page_map: torch.Tensor  # [num_slots, max_pages_per_slot] int32
    seq_lens: torch.Tensor  # [num_slots] int32

    @property
    def num_pages(self) -> int:
        return self.page_status.shape[0]


def init_page_state(num_pages: int, num_slots: int, max_pages_per_slot: int,
                    device=None) -> PageState:
    status = torch.zeros(num_pages, dtype=torch.int32, device=device)
    status[0] = 1  # the null page
    return PageState(
        page_status=status,
        page_map=torch.zeros((num_slots, max_pages_per_slot), dtype=torch.int32,
                             device=device),
        seq_lens=torch.zeros(num_slots, dtype=torch.int32, device=device),
    )


def _nth_free_pages(status: torch.Tensor, ranks: torch.Tensor) -> torch.Tensor:
    """Page id of the ``ranks``-th free page (1-based, any shape), or the null
    page 0 where fewer pages are free."""
    free_upto = torch.cumsum((status == 0).to(torch.int64), 0)  # non-decreasing
    ids = torch.searchsorted(free_upto, ranks.to(torch.int64))  # first id with that many free
    return torch.where(ids < status.shape[0], ids, torch.zeros_like(ids)).to(torch.int32)


def _take_free_pages(status: torch.Tensor, k_max: int, need) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``need`` free pages (``need <= k_max``). Returns (new_status,
    page_ids [k_max], the null page 0 beyond ``need``)."""
    ranks = torch.arange(1, k_max + 1, device=status.device)
    page_ids = torch.where(ranks <= need, _nth_free_pages(status, ranks),
                           torch.zeros((), dtype=torch.int32, device=status.device))
    new_status = status.clone()
    new_status[page_ids.long()] = 1  # page 0 is in use already
    return new_status, page_ids


def release_slot(state: PageState, slot: int) -> PageState:
    """Give the slot's pages back; its map row and length become 0."""
    pages = state.page_map[slot].long()
    status = state.page_status.clone()
    status[pages] = 0
    status[0] = 1
    page_map = state.page_map.clone()
    page_map[slot] = 0
    seq_lens = state.seq_lens.clone()
    seq_lens[slot] = 0
    return PageState(status, page_map, seq_lens)


def allocate_prefill(state: PageState, slot: int, true_length, tokens_per_page: int,
                     max_pages_per_slot: int) -> tuple[PageState, torch.Tensor]:
    """Release the slot, then reserve ``ceil(true_length / tokens_per_page)``
    pages for a prefilled sequence. Returns (state, page_ids [max_pages_per_slot])."""
    state = release_slot(state, slot)
    need = (true_length + tokens_per_page - 1) // tokens_per_page
    status, page_ids = _take_free_pages(state.page_status, max_pages_per_slot, need)
    page_map = state.page_map.clone()
    page_map[slot] = page_ids
    seq_lens = state.seq_lens.clone()
    seq_lens[slot] = true_length
    return PageState(status, page_map, seq_lens), page_ids


def allocate_decode_step(state: PageState, tokens_per_page: int,
                         active: torch.Tensor | None = None) -> PageState:
    """Advance each live slot by one token, growing a page at each boundary.

    ``active`` ([num_slots] bool) restricts the advance to live requests. The
    JAX function walks the slots in order and gives each slot that needs a
    page the first free one; here the j-th such slot in slot order takes the
    j-th free page in page order, which is the same page, in one pass."""
    seq = state.seq_lens
    cap = state.page_map.shape[1] * tokens_per_page
    live = (seq > 0) & (seq < cap)  # a slot at the cap is saturated
    if active is not None:
        live = live & active
    needs = live & (seq % tokens_per_page == 0)
    rank = torch.cumsum(needs.to(torch.int64), 0)  # 1-based among the slots that need one
    pages = torch.where(needs, _nth_free_pages(state.page_status, rank),
                        torch.zeros((), dtype=torch.int32, device=seq.device))
    status = state.page_status.clone()
    # slots that need none write the null page, in use already; the value is a
    # device tensor (a host number would be a copy a captured step cannot make)
    status.index_put_((pages.long(),), torch.ones_like(pages))
    rows = torch.arange(seq.shape[0], device=seq.device)
    cols = torch.clamp(seq // tokens_per_page, max=state.page_map.shape[1] - 1).long()
    page_map = state.page_map.clone()
    page_map[rows, cols] = torch.where(needs, pages, state.page_map[rows, cols])
    return PageState(status, page_map, torch.where(live, seq + 1, seq))


def num_free_pages(state: PageState) -> torch.Tensor:
    return torch.sum(1 - state.page_status)

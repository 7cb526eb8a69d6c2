"""PTW Cost Predictor (paper §5.2, Fig. 15/16, Table 2); port of
``repro.core.ptwcp``.

The production predictor is the 4-comparator bounding-box circuit: a page
is predicted costly-to-translate iff its (PTW cost, PTW frequency) counter
pair lies inside the box spanning (1,1)..(12,7):

    1 <= cost <= 12   (4-bit saturating counter, +1 per walk touching DRAM)
    1 <= freq <= 7    (3-bit saturating counter, +1 per walk)

Counters are dense per-page uint8 tables with a leading lane axis,
updated in place after every demand walk.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core.assoc import as_mask, idle, lane_ids

FREQ_BITS = 3
COST_BITS = 4
FREQ_MAX = (1 << FREQ_BITS) - 1  # 7
COST_MAX = (1 << COST_BITS) - 1  # 15

# bounding box from Fig. 16 — (cost, freq) in (1,1)..(12,7)
BOX_COST_LO, BOX_COST_HI = 1, 12
BOX_FREQ_LO, BOX_FREQ_HI = 1, 7


class PageCounters(NamedTuple):
    freq: torch.Tensor  # uint8 [W, n_pages]
    cost: torch.Tensor  # uint8 [W, n_pages]


def make_counters(n_pages: int, lanes: int = 1, device="cpu") -> PageCounters:
    return PageCounters(
        freq=torch.zeros((lanes, n_pages), dtype=torch.uint8, device=device),
        cost=torch.zeros((lanes, n_pages), dtype=torch.uint8, device=device),
    )


def update_counters(pc: PageCounters, page, had_dram, enable
                    ) -> PageCounters:
    """MMU updates after a demand PTW (saturating, in place)."""
    ln = lane_ids(page)
    page = page.long()
    en = as_mask(enable, ln)
    if idle(en):
        return pc
    f = pc.freq[ln, page]
    c = pc.cost[ln, page]
    nf = (f.int() + 1).clamp_max(FREQ_MAX).to(torch.uint8)
    nc = (c.int() + as_mask(had_dram, ln).int()).clamp_max(COST_MAX)
    pc.freq[ln, page] = torch.where(en, nf, f)
    pc.cost[ln, page] = torch.where(en, nc.to(torch.uint8), c)
    return pc


def predict(freq: torch.Tensor, cost: torch.Tensor) -> torch.Tensor:
    """The comparator tree — one cycle, 4 comparators, 4 threshold regs."""
    f = freq.int()
    c = cost.int()
    return ((c >= BOX_COST_LO) & (c <= BOX_COST_HI)
            & (f >= BOX_FREQ_LO) & (f <= BOX_FREQ_HI))


def predict_page(pc: PageCounters, page) -> torch.Tensor:
    ln = lane_ids(page)
    page = page.long()
    return predict(pc.freq[ln, page], pc.cost[ln, page])

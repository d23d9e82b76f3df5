"""The one traffic generator: a traffic file's parameters and a seed give
the requests.

A traffic file (``gpubench/traffic/<name>.json``) holds ``workload``
(the engine's ``forward`` or ``generate``), ``prompt_len``,
``gen_tokens``, ``b_max``, ``arrivals`` and ``rate_rps``.  ``poisson``
arrivals are a Poisson process at ``rate_rps`` conditioned on its count:
``round(rate · seconds)`` times drawn uniformly over the window and
sorted, so that every seed offers the same number of requests in
another order.  Prompts are uniform token ids, drawn on the device in
one call; the rows that pad a batch to its bucket are drawn apart.
"""
from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from gpubench.lib.weights import generator, sub_seed


def arrival_times(traffic: dict, seed: int, seconds: float) -> np.ndarray:
    """Seconds from the window's start at which each request is due."""
    if traffic["arrivals"] != "poisson":
        raise ValueError(f"unknown arrivals {traffic['arrivals']!r}")
    n = max(1, int(round(float(traffic["rate_rps"]) * seconds)))
    rng = np.random.default_rng(sub_seed(seed, "arrivals"))
    return np.sort(rng.uniform(0.0, seconds, n))


class Requests:
    def __init__(self, traffic: dict, seed: int, seconds: float, vocab: int,
                 device):
        self.traffic = traffic
        self.due = arrival_times(traffic, seed, seconds)
        s = int(traffic["prompt_len"])
        self.prompts = torch.randint(
            0, vocab, (len(self.due), s),
            generator=generator(seed, "prompts", device), device=device)
        self.pad = torch.randint(
            0, vocab, (int(traffic["b_max"]), s),
            generator=generator(seed, "pad", device), device=device)

    def __len__(self) -> int:
        return len(self.due)

    def batch(self, ids: Sequence[int], rows: int) -> Dict[str, torch.Tensor]:
        """The prompts of ``ids``, then pad rows up to ``rows``."""
        idx = torch.as_tensor(list(ids), dtype=torch.long).to(
            self.prompts.device, non_blocking=True)
        toks = self.prompts.index_select(0, idx)
        if rows > len(ids):
            toks = torch.cat([toks, self.pad[:rows - len(ids)]])
        return {"tokens": toks}

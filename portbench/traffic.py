"""The one traffic generator: a seeded stream of request inputs.

A traffic mix is a JSON file under ``traffic/`` that names its request
kind (``request``: ``solve``, ``build`` or ``solution``, see
``systems.py``) and the parameters this module reads.  Every mix is one
caller in a closed loop: the harness issues a request when the last one
has returned.

* ``rhs``: ``{"low": l, "high": h, "where": "device" | "host"}``, each
  request's right-hand side uniform on [l, h), drawn on the card (float32
  unless ``dtype`` says otherwise) or on the host (float64);
* ``copies`` and ``scale``: ``{"low": l, "high": h}``, that many positive
  scales of the matrix's values, each a float32 number, taken in turn;
* ``sample``: the share of requests whose answers the check judges,
  drawn from the seed (the first request's always);
* ``ranks``, ``shards_per_rank``, ``shard_levels``, ``backend``: a row
  mesh over that many rank processes, one card each.

Every draw is a pure function of (seed, request index), so the same seed
gives the same inputs whatever ran before, and every seed draws the same
sizes: only the values change (a solve's iteration count can still
differ by one or two between right-hand sides).
"""
from __future__ import annotations

import numpy as np
import torch

# the request index the warm-up request draws with (never a window's)
WARMUP = 2 ** 40


def _state(seed: int, *tags: int) -> int:
    """A 63-bit seed for one stream of draws: (seed, tags) mixed by
    numpy's SeedSequence (any non-negative integer is a valid seed)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, *tags])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


class Stream:
    """The inputs of one run's requests."""

    def __init__(self, traffic: dict, seed: int, n: int,
                 device: torch.device):
        self.traffic, self.seed, self.n = traffic, int(seed), int(n)
        self.device = torch.device(device)

    def rhs(self, i: int):
        """Request ``i``'s right-hand side: a (n,) tensor on the card, or
        a float64 numpy array on the host."""
        spec = self.traffic["rhs"]
        lo, hi = float(spec.get("low", 0.0)), float(spec.get("high", 1.0))
        if spec.get("where", "device") == "host":
            rng = np.random.default_rng(_state(self.seed, 1, i))
            return lo + (hi - lo) * rng.random(self.n)
        dtype = getattr(torch, spec.get("dtype", "float32"))
        g = torch.Generator(device=self.device)
        g.manual_seed(_state(self.seed, 1, i))
        u = torch.rand(self.n, generator=g, device=self.device, dtype=dtype)
        return u if (lo, hi) == (0.0, 1.0) else lo + (hi - lo) * u

    def sampled(self, i: int) -> bool:
        """Whether request ``i``'s answer is among those the check judges:
        each with probability ``sample`` (the traffic's, default 1),
        drawn from the seed."""
        p = float(self.traffic.get("sample", 1.0))
        return p >= 1.0 or _state(self.seed, 3, i) < p * 2 ** 63

    def scales(self) -> list[float]:
        """The ``copies`` value scales, each exactly a float32 number, in
        the order requests take them (request i takes i mod copies)."""
        spec = self.traffic["scale"]
        rng = np.random.default_rng(_state(self.seed, 2))
        s = rng.uniform(float(spec["low"]), float(spec["high"]),
                        int(self.traffic["copies"]))
        return [float(v) for v in s.astype(np.float32)]

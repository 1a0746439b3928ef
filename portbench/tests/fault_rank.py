"""A rank of a cell over ranks with its exchange between ranks left out
(every neighbour exchange delivers zeros), for the fault test:

    python -m portbench.tests.fault_rank <harness arguments>
"""
import sys

import torch

from multigridsolver_tpu_torch.parallel import multihost
from portbench.harness import main


def no_exchange(self, to_left, to_right):
    zeros = (lambda t: None if t is None else torch.zeros_like(t))
    has_left, has_right = self.rank > 0, self.rank + 1 < self.world
    return (zeros(to_right) if has_left else None,
            zeros(to_left) if has_right else None)


if __name__ == "__main__":
    multihost.RankComm.exchange = no_exchange
    raise SystemExit(main(sys.argv[1:]))

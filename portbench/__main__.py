"""``python3 -m portbench``: one run of one cell (``harness.main``).

The run, and every rank process it starts, holds the host's thread
pools (PyTorch's OpenMP pool, MKL, OpenBLAS) to one thread, set before
numpy or torch is imported: the load comes from one process with one
host thread, so a shared host's busy cores stall no parallel region
(the float64 → float32 casts of a host→card copy run on that pool)."""
import os
import time

T0 = time.time()
HOST_THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1",
                "OPENBLAS_NUM_THREADS": "1"}
os.environ.update(HOST_THREADS)

if __name__ == "__main__":
    from portbench.harness import main
    raise SystemExit(main(t0=T0))

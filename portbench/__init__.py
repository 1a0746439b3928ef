"""The benchmark of the PyTorch and CUDA port (``multigridsolver_tpu_torch``).

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

runs one cell of ``BENCHMARK.json`` once, from the root of a checkout, on
the card(s) the cell asks for, and prints one JSON object as the last line
of standard output (``harness.py``).  It imports the port, torch, numpy
and scipy, never JAX or the JAX package.  ``calibrate.py`` reads the
numbers the limits of ``limits/`` were set from.
"""

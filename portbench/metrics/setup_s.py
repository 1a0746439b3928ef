"""``setup_s``: from the process's start (for a cell over ranks, the
launcher's) to the window's, in seconds: imports, the kernels' build in a
checkout's first run, the matrix, the program's set-up and the warm-up
request."""


def read(run):
    return run.setup_s

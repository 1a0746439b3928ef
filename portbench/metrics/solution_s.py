"""``solution_s``: all of the window's wall time over the requests completed in
it (each request ends in a synchronise), in seconds."""


def read(run):
    return run.window_s / run.completed

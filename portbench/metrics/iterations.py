"""``iterations``: BiCGStab iterations per solve (``SolveResult``),
averaged over the window's requests."""


def read(run):
    its = run.rec.counters.get("iterations")
    return sum(its) / len(its) if its else None

"""``inner_iterations``: the inner iterations ``solve_refined`` reports
per request, averaged over the window's requests."""


def read(run):
    its = run.rec.counters.get("inner_iterations")
    return sum(its) / len(its) if its else None

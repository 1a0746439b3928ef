"""``ilu_factor_ms``: the device time of the program's ``ilu0.factor``
spans (one a level) over one ``build_hierarchy`` of the cell's setup,
summed, in milliseconds.  After the window the reader builds the cell's
setup again and runs ``build_hierarchy`` on it under the program's
tracer (``utils/timing``) made with ``device_spans``, which records a
CUDA event at each end of those spans (no synchronise); the time is
between each span's two events.  Nothing off the card, or from a program
whose tracer records no such span."""
import inspect

from portbench.trace import sync

SPAN = "ilu0.factor"


def read(run):
    from multigridsolver_tpu_torch.utils import timing
    system = run.system
    if (run.device.type != "cuda" or not hasattr(system, "hier")
            or not hasattr(timing, "tracing")
            or "device_spans" not in inspect.signature(
                timing.PhaseTimer).parameters):
        return None
    from multigridsolver_tpu_torch.setup.aggregation import build_amg_setup
    from multigridsolver_tpu_torch.solve.hierarchy import build_hierarchy
    from multigridsolver_tpu_torch.sparse.formats import CSR
    from portbench.systems import hierarchy_config
    cfg = system.config
    ell = CSR.from_scipy(system.a).to_ell(dtype=system.dtype,
                                          device=run.device,
                                          **cfg.get("pack", {}))
    setup = build_amg_setup(ell, hierarchy_config(cfg))
    sync(run.device)
    tracer = timing.PhaseTimer(device=run.device, device_spans=(SPAN,))
    with timing.tracing(tracer):
        hier = build_hierarchy(setup.matrices[0], setup.level_labels,
                               setup.matrices[1:], **cfg["hierarchy"])
    sync(run.device)
    by_level = tracer.device_seconds(SPAN)
    del hier, setup, ell
    if not by_level:
        return None
    return 1e3 * sum(by_level.values())

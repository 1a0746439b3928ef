"""``device_idle``: one minus the device's busy time over the traced
request's host wall, in %.  The busy time is the union of the device's
operation intervals (``trace.busy_seconds``) leaving out the transport's
kernels (``trace.is_transport``: NCCL's, which occupy the device while
they wait for a peer), so waiting on the transport reads as idle; on a
cell over ranks it is averaged over the ranks' cards.  The traced
request runs with the harness's spans only stamping the host's clock.
Nothing without a card's trace."""


def read(run):
    prof = run.profile
    if not prof or prof["window_s"] <= 0 or prof["compute_busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - prof["compute_busy_s"] / prof["window_s"])

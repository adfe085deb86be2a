"""The observation slot of the kernel wrappers and the collectives.

``active`` is None, or the tracer of a running
:func:`repro_torch.analysis.dataflow.trace_dataflow` (or the dry-run's
:class:`repro_torch.launch.dryrun.Counter`, which takes kernel calls only).  Every kernel wrapper
of :mod:`~repro_torch.kernels.strum_matmul` (K1-K3, K6-K10),
:mod:`~repro_torch.kernels.strum_attention` (K4, K5) and
:mod:`~repro_torch.kernels.strum_decode` (K11) hands its call, on either
route, to ``active.kernel(name, wrapper, *args, **kwargs)``, which records
it as one event and runs it; :mod:`repro_torch.models.sharding`'s
collectives report to ``active.collective(...)``.  With no trace active the
cost is the one ``if`` that reads the slot.
"""
import contextlib

active = None


@contextlib.contextmanager
def paused():
    """Empty the slot for the ``with`` block (the tracer runs a recorded
    call inside it, so the call is not recorded twice)."""
    global active
    saved, active = active, None
    try:
        yield
    finally:
        active = saved

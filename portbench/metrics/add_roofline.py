"""The executed graph's residual adds: their roofline bound (both legs
read and the output written once per lane, over the card's memory
bandwidth: ``harness/adds.py``) over the device time of the kernels named
``qadd_kernel`` in the trace, in percent."""


def read(rec):
    t, bound = rec.trace, getattr(rec, "add_bound_s", 0.0)
    if t is None or not bound or not rec.traced_dispatches:
        return None
    took = t.seconds(lambda name: name == "qadd_kernel")
    if took <= 0:
        return None
    return 100.0 * bound * rec.traced_dispatches / took

"""The executed graph's squeeze-and-excite channel scales: their roofline
bound (two bytes an element and the gate's byte a channel, once per
lane, over the card's memory bandwidth: ``harness/scales.py``) over the
device time of the kernels named ``qscale_kernel`` (K10) in the trace, in
percent."""


def read(rec):
    t, bound = rec.trace, getattr(rec, "scale_bound_s", 0.0)
    if t is None or not bound or not rec.traced_dispatches:
        return None
    took = t.seconds(lambda name: name == "qscale_kernel")
    if took <= 0:
        return None
    return 100.0 * bound * rec.traced_dispatches / took

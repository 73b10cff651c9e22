"""Launches of K10 (squeeze-and-excite's channel scale, ``qscale_kernel``)
per dispatch over the traced stretch: its wrapper's ``launches`` counter
over the traced dispatches, given only where the trace holds as many
``qscale_kernel`` activities as the counter moved.  It equals the executed
schedule's ``qmul`` count where every scale of a dispatch is one launch."""


def read(rec):
    n, t = getattr(rec, "scale_launches", 0), rec.trace
    if not n or t is None or not rec.traced_dispatches:
        return None
    if t.count(lambda name: name == "qscale_kernel") != n:
        return None
    return n / rec.traced_dispatches

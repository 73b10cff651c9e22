"""Device activities (kernels, copies, memsets) per dispatch in the trace,
given only where the port's kernels among them equal the launches the
kernel wrappers counted over the same dispatches."""
from portbench.harness import spec


def read(rec):
    t, n = rec.trace, rec.traced_dispatches
    if t is None or not n:
        return None
    kinds = spec.data("kernel_kinds")
    if t.count(lambda name: name in kinds) != sum(rec.traced_launches.values()):
        return None
    return t.activities / n

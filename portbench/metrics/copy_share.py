"""Device time of copies (any direction, copy kernels included) over the
device's busy time, in the trace."""
from portbench.harness.readers import copy_share


def read(rec):
    return copy_share(rec)

"""The executed graph's 1x1 convolutions: their roofline bound over the
device time of the kernels that run them, in percent."""
from portbench.harness.readers import roofline


def read(rec):
    return roofline(rec, "pointwise")

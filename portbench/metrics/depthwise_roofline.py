"""The executed graph's depthwise convolutions: their roofline bound over
the device time of the kernels that run them, in percent."""
from portbench.harness.readers import roofline


def read(rec):
    return roofline(rec, "depthwise")

"""The whole step's share of the card's int8 peak: the model's own
operations per image times images per second, in percent."""
from portbench.harness.readers import mfu


def read(rec):
    return mfu(rec)

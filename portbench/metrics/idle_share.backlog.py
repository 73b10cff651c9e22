"""1 - the union of the card's busy intervals over the traced stretch."""
from portbench.harness.readers import idle_share


def read(rec):
    return idle_share(rec)

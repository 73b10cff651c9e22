"""Multiply-accumulates the executed graph (slices, tiles, rings) does for
one image beyond the unsliced model's, as a share of the model's: the
halo the schedule recomputes.  Both counted from the graphs' shapes."""


def read(rec):
    if not rec.model_macs:
        return None
    return rec.executed_macs / rec.model_macs - 1.0

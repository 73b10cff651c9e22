"""Host seconds of ``deploy.build``: quantize (calibration on the card),
schedule, plan, validate, compile.  The benchmark's span around the call."""


def read(rec):
    return rec.build_s or None

"""Process start to the first timed request: imports, CUDA, inputs,
graph, quantize, schedule, plan, compile, capture and warm-up."""


def read(rec):
    return rec.setup_s

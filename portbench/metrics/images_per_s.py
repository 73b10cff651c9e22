"""Requests the window's dispatches completed, over the window: from its
opening to the end of its last dispatch."""


def read(rec):
    if rec.window_s <= 0 or not rec.completed:
        return None
    return rec.completed / rec.window_s

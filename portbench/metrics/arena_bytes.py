"""Bytes of one lane of the arena the deployment serves from: the SRAM
a microcontroller would need (``Deployment.arena_bytes``)."""


def read(rec):
    return rec.arena_bytes or None

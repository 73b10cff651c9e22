"""Runtime analysis flags: ``src/repro/models/runtime.py`` on PyTorch.

In the reference, XLA's cost analysis counts a ``lax.scan`` body once,
so the dry-run re-lowers the model with its scans unrolled for the
roofline pass.  In the port the layer stacks are Python loops, so a
dispatch-level counter (``launch/dryrun.py``'s) sees every layer of
prefill and of a training step whatever this flag says.  What the flag
changes is the decode step:

* rolled (``UNROLL_SCANS = False``): ``Model.decode_step(...,
  traced=True)`` runs the layer stack as one custom operator
  (``repro_torch::decode_layers`` / ``decode_recurrent_layers``), whose
  body no dispatch-level counter sees — the counterpart of XLA's while
  body, except that it counts zero layers where XLA counts one;
* unrolled (``UNROLL_SCANS = True``): the step runs its per-layer loop,
  so FLOPs, bytes and collectives cover every layer.

What it cannot change: the chunk loops of the chunked attention and of
the recurrences are Python loops on both settings, and so is the sLSTM's
time loop (the reference never unrolls that one), so they are counted in
full either way; and the serving path itself always runs the per-layer
loop.
"""

UNROLL_SCANS = False


def scan_unroll():
    """1 (rolled) or True (unrolled), the reference's ``lax.scan(unroll=)``
    value; the port's decode step reads ``UNROLL_SCANS`` itself."""
    return True if UNROLL_SCANS else 1

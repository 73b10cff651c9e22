"""What the compiled forms need of the port, checked on the CPU.

On the card, ``CompiledExecutor.fn``/``batched_fn`` and the LLM engine's
decode step are CUDA graphs (``repro_torch.cuda_graphs``): a replay runs
the captured kernels and no Python.  So the captured code must make no
host read of the card's data, must not copy host data in after its first
(warm-up) run, and must update its state in place.  This file checks that
on the CPU, where the same code runs eagerly:

* ``execute`` of the int8 MobileNet-0.25@96 program (reorder only, and a
  ring cascade with zero-copy windows) and of the float32 Figure 1
  program, and ``Model.decode_step`` on the card's routing, under a
  dispatch mode that fails on a host read (``aten._local_scalar_dense``,
  what ``int()``/``.item()`` reach; ``.tolist()``/``.numpy()``), a
  data-dependent shape (``nonzero``, ``masked_select``) or a tensor made
  from host data (``aten.lift_fresh``: a host-to-device copy on the card);
* the launch accounting of ``cuda_graphs.capture`` with the CUDA calls
  replaced by plain ones: a replay adds exactly the captured launches;
* ``fn``/``batched_fn`` refuse a program with an ``op.fn`` fallback with
  ``CaptureError`` naming the operator, before anything touches CUDA;
* on the CPU, ``fn``/``batched_fn`` run ``execute`` over their static
  arena and carry nothing from one dispatch to the next;
* a staged dispatch's zero, scatter and gather are inside the recorded
  program: the host only stages, uploads, replays and downloads.
"""
import contextlib
import dataclasses

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro_torch.models.model as model_mod
from repro_torch import cuda_graphs
from repro_torch.configs import get_config
from repro_torch.core import cascade_graph
from repro_torch.errors import CaptureError
from repro_torch.graphs import (figure1_executable_graph, mobilenet_v1_graph,
                                quantize_graph, random_input)
from repro_torch.kernels.conv_quant import ops as cq_ops
from repro_torch.kernels.decode_attention import ops as dec_ops
from repro_torch.mcu.compile import compile_schedule
from repro_torch.models import Model, init_params

# One intra-op thread: the suite runs in several worker processes at
# once, and idle OpenMP threads spinning in each would starve the rest.
torch.set_num_threads(1)

aten = torch.ops.aten
_HOST = {aten._local_scalar_dense, aten.nonzero, aten.masked_select,
         aten.lift_fresh, aten.lift_fresh_copy}


class _NoHostRead(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in _HOST:
            raise AssertionError(f"{func} in code a CUDA graph replays")
        return func(*args, **(kwargs or {}))


@contextlib.contextmanager
def no_host_reads(monkeypatch):
    """Fail on anything a captured program could not replay (see the
    module docstring)."""
    def refuse(name):
        def f(*a, **kw):
            raise AssertionError(f"Tensor.{name}() in code a CUDA graph "
                                 f"replays")
        return f
    with monkeypatch.context() as m:
        for name in ("tolist", "numpy", "item"):
            m.setattr(torch.Tensor, name, refuse(name))
        with _NoHostRead():
            yield


@pytest.fixture(scope="module")
def int8_mobilenet():
    """The port's own int8 MobileNet-0.25@96."""
    pf = mobilenet_v1_graph(0.25, 96)
    return quantize_graph(pf, random_input(pf), device="cpu").graph


def _program(which, int8_mobilenet):
    if which == "figure1-f32":
        g = figure1_executable_graph()
        order = ["op1", "op4", "op6", "op2", "op3", "op5", "op7"]
        return compile_schedule(g, [g.op_by_name(n) for n in order],
                                device="cpu")
    g = int8_mobilenet
    if which == "int8-cascade":
        budget = int(0.5 * g.peak_usage(g.default_schedule()))
        g = cascade_graph(g, budget=budget).graph
    return compile_schedule(g, device="cpu")


@pytest.mark.parametrize("which", ["int8-reorder", "int8-cascade",
                                   "figure1-f32"])
def test_execute_makes_no_host_read(which, int8_mobilenet, monkeypatch):
    """After one warm-up run (the capture's), the program runs with no
    host read, no data-dependent shape and no host data copied in; its
    output is the warm-up's."""
    ex = _program(which, int8_mobilenet)
    if which == "int8-cascade":
        assert ex.zero_copy_reads > 0 and ex.rolled_loops > 0
    x = random_input(ex.graph, seed=4)
    want = ex.outputs_from(ex.execute(ex.make_arena(x)))
    arena = ex.make_arena(x)
    with no_host_reads(monkeypatch):
        ex.execute(arena)
    for name, val in ex.outputs_from(arena).items():
        np.testing.assert_array_equal(val, want[name])


@pytest.fixture(scope="module")
def smoke_llm():
    cfg = get_config("llama3.2-3b@smoke")
    return cfg, init_params(cfg, device="cpu")


@pytest.mark.parametrize("route", ["card", "cpu", "sliding-window"])
def test_decode_step_makes_no_host_read_and_stays_in_place(
        route, smoke_llm, monkeypatch):
    """``decode_step`` on the card's routing (forced on CPU tensors: K8's
    plain version stands in), on the CPU's and with a sliding window:
    no host read, and ``k``, ``v``, ``kv_pos`` and ``pos`` are updated
    where they lie, so one captured step can be replayed."""
    cfg, params = smoke_llm
    if route == "sliding-window":
        cfg = cfg.with_sliding_window(8)
    if route == "card":
        monkeypatch.setattr(model_mod, "_on_card", lambda cfg, x: True)
    model = Model(cfg)
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (2, 6)))
    logits, cache = model.prefill(params, {"tokens": toks}, cache_len=10)
    ptrs = {n: t.data_ptr() for n, t in cache.items()}
    assert cache["pos"].dtype == torch.int32 and cache["pos"].dim() == 0
    launches = dec_ops.decode_attention.launches
    tok = torch.argmax(logits, -1)
    for _ in range(6):          # past the cache's (or window's) end
        with no_host_reads(monkeypatch):
            logits, out = model.decode_step(params, cache, tok)
            tok = torch.argmax(logits, -1)
        assert out is cache
        assert {n: t.data_ptr() for n, t in cache.items()} == ptrs
    assert int(cache["pos"]) == 12
    assert torch.isfinite(logits).all()
    assert dec_ops.decode_attention.launches == launches   # plain version


class _FakeGraph:
    """A recorded run.  Without ``fn`` it replays nothing in Python, as
    on the card; with ``fn`` (the recorded program) and ``out`` (what the
    recording returned) a replay reruns ``fn`` and copies every tensor of
    its result into ``out``'s, as a replay rewrites the graph's output
    tensors (tensors the program updates in place are ``out``'s
    already)."""
    replays = 0

    def __init__(self, fn=None, out=None):
        self.fn, self.out = fn, out

    def replay(self):
        _FakeGraph.replays += 1
        if self.fn is not None:
            new = torch.utils._pytree.tree_leaves(self.fn())
            old = torch.utils._pytree.tree_leaves(self.out)
            assert len(new) == len(old)
            with torch.no_grad():
                for o, n in zip(old, new):
                    if isinstance(o, torch.Tensor) and o is not n:
                        o.copy_(n)


def _fake_cuda(monkeypatch, record=None):
    def warm_up(fn, device, runs=cuda_graphs.WARMUP_RUNS):
        out = None
        for _ in range(runs):
            out = fn()
        return out

    def plain_record(fn, device):
        return _FakeGraph(), fn()
    monkeypatch.setattr(cuda_graphs, "_warm_up", warm_up)
    monkeypatch.setattr(cuda_graphs, "_record", record or plain_record)


def test_replay_adds_exactly_the_captured_launches(monkeypatch):
    """Warm-up runs count (they launch); the recorded run does not (it
    launches nothing); every replay adds what the recorded run counted."""
    _fake_cuda(monkeypatch)
    k1, k8 = cq_ops.qconv1x1, dec_ops.decode_attention
    monkeypatch.setattr(k1, "launches", 5)
    monkeypatch.setattr(k8, "launches", 0)

    def program():
        k1.launches += 3
        k8.launches += 1
        return "out"
    g = cuda_graphs.capture(program, torch.device("cpu"), what="a program")
    assert g.output == "out"
    assert (k1.launches, k8.launches) == (5 + 3 * cuda_graphs.WARMUP_RUNS,
                                          cuda_graphs.WARMUP_RUNS)
    assert {n: k for n, k in g.launches.items() if k} == \
        {"qconv1x1": 3, "decode_attention": 1}
    assert set(g.launches) == set(cuda_graphs.kernel_wrappers())
    base = (k1.launches, k8.launches)
    for n in range(1, 4):
        g.replay()
        assert (k1.launches, k8.launches) == (base[0] + 3 * n, base[1] + n)


def test_a_failed_capture_or_replay_raises_capture_error(monkeypatch):
    """The error names the program and the step that was running; the
    counters are left as the warm-up made them."""
    def broken_record(fn, device):
        try:
            raise RuntimeError("operation not permitted when stream is "
                               "capturing")
        except RuntimeError as e:
            e.add_note("operator 'conv3' (kind 'qconv')")
            raise
    _fake_cuda(monkeypatch, broken_record)
    k1 = cq_ops.qconv1x1
    monkeypatch.setattr(k1, "launches", 0)

    def program():
        k1.launches += 1
    with pytest.raises(CaptureError, match=r"capture of the program failed "
                       r"\(operator 'conv3' \(kind 'qconv'\)\)"):
        cuda_graphs.capture(program, torch.device("cpu"), what="the program")
    assert k1.launches == cuda_graphs.WARMUP_RUNS

    class Lost:
        def replay(self):
            raise RuntimeError("device lost")
    g = cuda_graphs.CapturedGraph(Lost(), None, {"qconv1x1": 1}, 0.0, 0.0,
                                  "the program")
    with pytest.raises(CaptureError, match="replay of the program failed"):
        g.replay()
    assert k1.launches == cuda_graphs.WARMUP_RUNS     # nothing ran


def test_op_fn_fallback_is_refused_before_anything_touches_cuda():
    """Figure 1's kinds run their ``op.fn`` (``execute``'s fallback): the
    capture check names the first such operator, and ``fn``/``batched_fn``
    of the program on the card raise it before allocating anything."""
    ex = _program("figure1-f32", None)
    with pytest.raises(CaptureError, match="operator 'op1' .*op.fn"):
        ex.check_capturable()
    card = dataclasses.replace(ex, device=torch.device("cuda"),
                               _fn_cache={})
    with pytest.raises(CaptureError, match="operator 'op1'"):
        card.fn
    with pytest.raises(CaptureError, match="operator 'op1'"):
        card.batched_fn(4)
    x = random_input(ex.graph)      # the CPU runs it through execute
    np.testing.assert_array_equal(
        ex.run(x)["t7"], ex.outputs_from(ex.execute(ex.make_arena(x)))["t7"])


def test_fn_and_batched_fn_on_the_cpu(int8_mobilenet, monkeypatch):
    """On the CPU the compiled forms run ``execute`` over their static
    arena, cached per lane count: each dispatch starts from zero, so a
    lane equals its one-shot run whatever ran before, and a pad lane's
    inputs are zero."""
    ex = _program("int8-reorder", int8_mobilenet)
    ex.check_capturable()           # every operator has a lowering rule
    assert ex.fn is ex.batched_fn(1) and ex.batched_fn(3) is ex.batched_fn(3)
    xs = [random_input(ex.graph, seed=s) for s in range(5)]
    one = [ex.outputs_from(ex.execute(ex.make_arena(x))) for x in xs]
    (inp,) = [t for t in ex.graph.constants() if ex.graph.consumers(t)]
    off, size = ex.offsets[inp]
    pad_inputs = []
    execute = ex.execute

    def spy(arena):
        if arena.shape[0] == 3:
            pad_inputs.append(arena[2, off:off + size].clone())
        return execute(arena)
    monkeypatch.setattr(ex, "execute", spy)
    prog = ex.batched_fn(3)
    for first in (0, 3):
        chunk = xs[first:first + 3]
        arena = prog(chunk)
        assert arena is prog.arena
        for lane in range(len(chunk)):
            for name, val in ex.outputs_from(arena, lane).items():
                np.testing.assert_array_equal(val, one[first + lane][name])
    assert pad_inputs[0].any() and not pad_inputs[1].any()
    (name, val), = one[0].items()
    np.testing.assert_array_equal(ex.run(xs[0])[name], val)
    with pytest.raises(ValueError, match="4 requests for 3 lanes"):
        prog(xs[:4])


def test_staged_lanes_move_inside_the_captured_graph(int8_mobilenet,
                                                     monkeypatch):
    """Under fake CUDA calls the device work of a staged dispatch is what
    the graph recorded: the host stages the rows, uploads them, replays
    and downloads, and leaves the arena alone; inside the replay the arena
    is zeroed, the rows are scattered into the lanes' input slots (a pad
    lane stays all zero), the program runs and the outputs are gathered
    into the device rows that come back."""
    recorded = []

    def record(fn, device):
        recorded.append(fn)
        out = fn()
        return _FakeGraph(fn, out), out
    _fake_cuda(monkeypatch, record)
    ex = _program("int8-reorder", int8_mobilenet)
    xs = [random_input(ex.graph, seed=s) for s in range(5)]
    one = [ex.outputs_from(ex.execute(ex.make_arena(x))) for x in xs]
    prog = ex.batched_fn(3)
    prog.capture()
    assert recorded == [prog.device_work]
    (inp,) = ex.arena_inputs
    off, size = ex.offsets[inp]
    (out,) = ex.graph.outputs
    seen = {}
    replay = _FakeGraph.replay

    def spy_replay(self):
        seen["arena"] = prog.arena.clone()
        seen["rows"] = prog.dev_in.clone()
        seen["gathered"] = prog.dev_out.clone()
        replay(self)
        seen["after"] = prog.dev_out.clone()
    monkeypatch.setattr(_FakeGraph, "replay", spy_replay)
    started = []
    execute = ex.execute
    monkeypatch.setattr(ex, "execute", lambda a: (started.append(a.clone()),
                                                  execute(a))[1])
    replays = _FakeGraph.replays
    for first in (0, 3):
        chunk = xs[first:first + 3]
        prog.arena.fill_(0xFF)
        prog.dev_out.fill_(0xFF)
        assert prog(chunk) is prog.arena
        # the host left the arena and the gathered rows alone
        assert (seen["arena"] == 0xFF).all()
        assert (seen["gathered"] == 0xFF).all()
        for lane in range(3):
            want = (torch.as_tensor(chunk[lane][inp]).reshape(-1)
                    .view(torch.uint8) if lane < len(chunk)
                    else torch.zeros(size, dtype=torch.uint8))
            assert torch.equal(seen["rows"][lane], want)
            assert torch.equal(started[-1][lane, off:off + size], want)
        assert not started[-1][len(chunk):].any()     # pad lanes: all zero
        assert prog.staged_rows == len(chunk)
        for lane in range(len(chunk)):
            got = ex.outputs_from(prog, lane)[out]
            np.testing.assert_array_equal(got, one[first + lane][out])
            np.testing.assert_array_equal(          # gathered in the replay
                seen["after"][lane, :got.nbytes].numpy(),
                got.reshape(-1).view(np.uint8))
    assert _FakeGraph.replays == replays + 2 and len(started) == 2
    assert ex.counters["replays"] == 2

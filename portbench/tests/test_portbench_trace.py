"""Reading a profile: the card's busy union, activities by name, idle
gaps labelled with the host's span, the benchmark's own annotations left
out of the card's work."""
import pytest

from portbench.harness import trace


class Ev:
    def __init__(self, name, dev, start, end):
        self._n, self._d, self._s, self._e = name, dev, start, end

    def name(self):
        return self._n

    def device_type(self):
        import torch
        return (torch.autograd.DeviceType.CUDA if self._d
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


class Prof:
    def __init__(self, events):
        class K:
            def events(self_):
                return events

        class P:
            kineto_results = K()
        self.profiler = P()


def test_summary_of_a_traced_stretch():
    us = 1_000_000          # a millisecond, in ns
    events = [
        Ev(trace.WINDOW, False, 0, 1000 * us),
        Ev("pb.client", False, 0, 300 * us),
        Ev("pb.step", False, 300 * us, 1000 * us),
        Ev("cudaGraphLaunch", False, 500 * us, 620 * us),
        Ev("pb.step", True, 300 * us, 1000 * us),       # an annotation
        Ev("void qconv1x1_kernel<4>(int)", True, 320 * us, 420 * us),
        Ev("void qdwconv_kernel<3>(int)", True, 425 * us, 500 * us),
        Ev("Memcpy DtoD (Device -> Device)", True, 450 * us, 480 * us),
        Ev("void at::native::elementwise_kernel<128, 2, direct_copy_kernel"
           "_cuda>()", True, 600 * us, 650 * us),
        Ev("Activity Buffer Request", True, 0, 900 * us),
    ]
    s = trace.summarize(Prof(events))
    assert s.window_s == pytest.approx(1.0)
    # 320-420, 425-500 (the copy inside it), 600-650
    assert s.busy_s == pytest.approx(0.225)
    assert s.by_name["qconv1x1_kernel"] == (1, pytest.approx(0.1))
    assert s.by_name["copy kernel"][0] == 1
    assert s.by_name["Memcpy DtoD"][0] == 1
    assert "pb.step" not in s.by_name
    assert s.seconds(trace.is_copy) == pytest.approx(0.08)
    # a gap goes to what the host did at its midpoint
    assert s.idle_by_host["pb.client"] == pytest.approx(0.32)
    assert s.idle_by_host["pb.step > cudaGraphLaunch"] == pytest.approx(0.1)
    assert s.idle_by_host["pb.step"] == pytest.approx(0.355)
    assert sum(s.idle_by_host.values()) == pytest.approx(1.0 - 0.225)


def test_no_device_activity_reads_nothing():
    events = [Ev(trace.WINDOW, False, 0, 10), Ev("pb.step", True, 0, 10)]
    assert trace.summarize(Prof(events)) is None

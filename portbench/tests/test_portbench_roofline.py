"""Least bytes of the kernels for hand-checked shapes, and the trace's
reduction to busy time, launches and idle gaps."""

from portbench import roofline
from portbench.devtrace import CALL, _Event, summarise


def test_dense_bytes_read_a_once():
    assert roofline.dense_price_bytes(768, 1536, 8) == 768 * 1536 * 8 + 768 * 8
    assert roofline.dense_price_bytes(2, 3, 4) == 2 * 3 * 4 + 2 * 4


def test_element_size_from_the_template_argument():
    assert roofline.elem_of("void dense_price_kernel<double>(...)") == 8
    assert roofline.elem_of("void dense_price_kernel<float>(...)") == 4


def test_peak_of_the_h100():
    assert roofline.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12


def _ev(name, start, end, kind, thread=1):
    return _Event(name, float(start), float(end), thread, kind)


def test_summarise_unions_intervals_and_names_gaps():
    events = [
        _ev("aten::mm", 0, 100, "host"),
        _ev("k1", 10, 30, "device"), _ev("k2", 20, 40, "device"),   # overlap: busy 30
        _ev("aten::item", 60, 90, "host"),
        _ev("Memcpy DtoH", 70, 80, "device"),                       # a copy: busy, no launch
        _ev(CALL, 0, 100, "other"),                                 # its copy on the device
        _ev("k1", 150, 160, "device"),                              # outside the call
    ]
    (s,), ops, gaps = summarise(events, [(0, 100)])
    assert s.launches == 2 and abs(s.busy_s - 40e-9) < 1e-18
    assert abs(s.window_s - 100e-9) < 1e-18
    assert s.kernels["k1"] == (1, 20e-9)
    assert ops[0][0] == "k1"
    by = dict(gaps)
    # gaps 0-10, 40-70, 80-100 inside the call: 10 + 30 + 20 ns
    assert abs(sum(by.values()) - 60e-9) < 1e-18
    assert abs(by["aten::item"] - 20e-9) < 1e-18  # 80-100 began inside aten::item

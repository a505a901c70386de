"""The readers of the program's spans (`harness/spans.py` and the four
`metrics/*.py` that use it) on synthetic traced windows: host ranges and
ops as `Trace._host` keeps them, busy intervals as `Trace.busy`, in ns."""

from __future__ import annotations

from types import SimpleNamespace

import pytest

from harness import spec

MS = 10**6


def _reading(kind, host, busy, units=1, lo=0, hi=100 * MS):
    trace = SimpleNamespace(_host=sorted(host), busy=busy, lo=lo, hi=hi)
    return SimpleNamespace(kind=kind, units=units, trace=trace)


def _read(metric, r):
    return spec.metric_reader(metric).read(r)


# (metric, kind of its cells, the span it reads or None for the union of all)
READERS = [("program_idle_ms.score", "score", None),
           ("program_idle_ms.train", "train", "train_step"),
           ("encoder_host_ms.score", "score", "encoder"),
           ("flow_host_ms.score", "score", "flow")]


def _outer(name):
    """The span the case nests under: the reader's own, or the payload."""
    return "vitad::" + (name or "payload")


@pytest.mark.parametrize("metric,kind,name", READERS)
def test_nested_spans_count_once(metric, kind, name):
    """A span and the spans inside it (and a second, overlapping one of the
    same name) count their union; the device is idle all through."""
    host = [(10 * MS, 30 * MS, _outer(name)), (12 * MS, 20 * MS, "vitad::block"),
            (15 * MS, 25 * MS, _outer(name)), (11 * MS, 13 * MS, "aten::mm")]
    busy = [(90 * MS, 95 * MS)]
    assert _read(metric, _reading(kind, host, busy)) == pytest.approx(20.0)


@pytest.mark.parametrize("metric,kind,name", READERS[:2])
def test_idle_outside_every_span_is_not_counted(metric, kind, name):
    """Of a span over [10, 40] ms with the device busy over [20, 30] and
    idle elsewhere, only the 20 idle ms inside the span count."""
    host = [(10 * MS, 40 * MS, _outer(name)), (50 * MS, 60 * MS, "aten::copy_")]
    busy = [(20 * MS, 30 * MS), (70 * MS, 80 * MS)]
    assert _read(metric, _reading(kind, host, busy)) == pytest.approx(20.0)


@pytest.mark.parametrize("metric,kind,name", READERS)
def test_spans_are_clipped_to_the_window(metric, kind, name):
    """Spans that begin before the window or end after it count their part
    inside [lo, hi]."""
    host = [(0, 30 * MS, _outer(name)), (80 * MS, 130 * MS, _outer(name))]
    busy = [(40 * MS, 50 * MS)]
    r = _reading(kind, host, busy, lo=10 * MS, hi=100 * MS)
    assert _read(metric, r) == pytest.approx(40.0)


@pytest.mark.parametrize("metric,kind,name", READERS)
@pytest.mark.parametrize("case", ["other kind", "no span", "span outside the window",
                                  "no unit"])
def test_none_where_there_is_nothing_to_read(metric, kind, name, case):
    host = [(10 * MS, 20 * MS, _outer(name))]
    busy = [(30 * MS, 40 * MS)]
    units = 1
    if case == "other kind":
        kind = {"score": "train", "train": "score"}[kind]
    elif case == "no span":
        host = [(10 * MS, 20 * MS, "aten::mm"), (10 * MS, 20 * MS, "bench::encoder")]
    elif case == "span outside the window":
        host = [(200 * MS, 210 * MS, _outer(name))]
    else:
        units = 0
    assert _read(metric, _reading(kind, host, busy, units)) is None


@pytest.mark.parametrize("metric,kind,name", READERS[1:])
def test_a_named_reader_reads_its_span_alone(metric, kind, name):
    """A reader of one span finds nothing in another span of the program."""
    host = [(10 * MS, 20 * MS, "vitad::mdn"), (10 * MS, 20 * MS, "vitad::payload")]
    assert _read(metric, _reading(kind, host, [(30 * MS, 40 * MS)])) is None


@pytest.mark.parametrize("metric,kind,name", READERS[:2])
def test_idle_reader_needs_device_activity(metric, kind, name):
    """A window with no kernel and no copy at all (a run without a card) has
    no device-idle reading."""
    host = [(10 * MS, 20 * MS, _outer(name))]
    assert _read(metric, _reading(kind, host, [])) is None


@pytest.mark.parametrize("metric,kind,name", READERS)
def test_divided_by_units(metric, kind, name):
    """Four units of 5 ms of span each, the device idle throughout: 5 ms a
    unit."""
    host = [(t * MS, (t + 5) * MS, _outer(name)) for t in (10, 20, 30, 40)]
    busy = [(90 * MS, 99 * MS)]
    assert _read(metric, _reading(kind, host, busy, units=4)) == pytest.approx(5.0)

"""The profiler arithmetic on made-up sessions, and one tiny cell on the
card (skipped without one)."""
from __future__ import annotations

import pytest

from perfbench_tiny import cells, tiny_root


def test_merge_joins_overlapping_intervals():
    from perfbench.profiling import _merge
    assert _merge([(0, 2), (1, 3), (5, 6), (6, 7)]) == [[0, 3], [5, 7]]


def test_idle_gaps_are_cut_at_span_edges():
    from perfbench.profiling import idle_gaps
    sess = dict(t0_ns=0, t1_ns=100, intervals_ns=[(10, 20), (50, 60)])
    spans = [("outer", 0, 100), ("inner", 15, 30), ("late", 60, 40)]
    gaps = dict(idle_gaps(sess, spans))
    # 0-10 in outer; 20-45 in inner (15-45), 45-50 in outer again;
    # 60-100 in late
    assert gaps == pytest.approx({"outer": 15e-9, "inner": 25e-9,
                                  "late": 40e-9})


def test_raw_events_are_read_and_summed_by_name():
    """The profiler's raw events, read here on the host's own device:
    every call is there, with its time, and summed by name."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from perfbench.profiling import by_name, device_events
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for _ in range(5):
            x.add_(1)
    events = device_events(prof, device="CPU")
    assert all(t1 >= t0 for _, t0, t1 in events)
    rows = {k: (s, c) for k, s, c in by_name(events)}
    assert rows["aten::add_"][1] == 5 and rows["aten::add_"][0] > 0
    assert by_name([("k", 0, 4), ("k", 10, 12), ("m", 0, 1)]) == \
        [("k", 6e-9, 2), ("m", 1e-9, 1)]


def test_idle_gaps_without_device_intervals_are_empty():
    from perfbench.profiling import idle_gaps
    assert idle_gaps(dict(t0_ns=0, t1_ns=5, intervals_ns=[]), []) == []


@pytest.mark.requires_cuda
def test_tiny_cell_on_the_card(capsys, tmp_path):
    """A traced run of a tiny cell on the card: correct, with the
    profiler's metrics and the device block filled in."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    root = tiny_root(tmp_path)
    from perfbench import run
    rc = run.main(["--workload", cells()[0], "--seed", "7", "--seconds",
                   "1", "--trace", "1"], root=root)
    out, err = capsys.readouterr()
    assert rc == 0, err
    import json
    line = json.loads(out.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert {"loop.launches_per_cycle", "device.idle_pct",
            "netstep.roofline_pct"} <= set(line["metrics"])
    assert line["metrics"]["netstep.roofline_pct"]["value"] <= 100

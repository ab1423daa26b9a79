"""The reader of `loop.graphed_pct`: its arithmetic on hand-made
`sim.cycles` spans, nothing where no span carries `graphed` or where the
run was off the card, and one traced tiny CPU run whose eager spans say
so (`graphed` = 0) while the line leaves the metric out."""
from __future__ import annotations

import pytest

from perfbench_tiny import REPO, cells, run_cell, tiny_root

from perfbench.run import load_reader

CARD = {"platform": "gpu"}
CPU = {"platform": "cpu"}


def _span(name, dur, **args):
    from repro_torch.obs.trace import Span
    return Span(name=name, cat="sim", ts=0, dur=dur, args=args)


def _read(name, spans, device=CARD):
    return load_reader(REPO, name).read({"spans": spans, "device": device})


def _graphed_chunks():
    """A graphed group of 302 cycles: two chunks with replays, and one
    eager chunk of the two cycles each body runs before its capture."""
    return [_span("sim.cycles", 90_000, cycles=256, graphed=254,
                  replay_ns=60_000),
            _span("sim.cycles", 40_000, cycles=44, graphed=44,
                  replay_ns=30_000),
            _span("sim.cycles", 5_000, cycles=2, graphed=0, alloc_calls=2,
                  alloc_ns=900)]


def test_graphed_pct_is_replayed_cycles_over_cycles():
    """The share is the replayed cycles over all the window's cycles; a
    window of eager chunks on the card reads 0."""
    spans = _graphed_chunks()
    assert _read("loop.graphed_pct", spans) == pytest.approx(
        100 * 298 / 302)
    assert _read("loop.graphed_pct", spans[2:]) == 0


@pytest.mark.parametrize("spans", [
    [_span("sim.cycles", 5_000, cycles=10, alloc_calls=10, alloc_ns=900)],
    [_span("sweep.group", 9_000, s_live=1)],
    [],
], ids=["no-attribute", "no-cycles-span", "no-spans"])
def test_graphed_pct_needs_the_attribute(spans):
    """The loop's spans of a program without graphs carry no `graphed`:
    no reading, not a share of 0, and the reader raises nothing."""
    assert _read("loop.graphed_pct", spans) is None


def test_graphed_pct_reads_nothing_off_the_card():
    """Off the card the loop cannot replay a graph: no reading, even
    where the spans carry `graphed`."""
    assert _read("loop.graphed_pct", _graphed_chunks(), CPU) is None


def test_traced_tiny_run_leaves_the_metric_out(capsys, tmp_path,
                                              monkeypatch):
    """A traced run on the CPU: every chunk ran eagerly (`graphed` = 0,
    the allocator's calls lapped), and the line has no `loop.graphed_pct`."""
    from perfbench.drivers import sim
    recs = []
    run = sim.run

    def keep(**kw):
        recs.append(run(**kw))
        return recs[-1]

    monkeypatch.setattr(sim, "run", keep)
    root = tiny_root(tmp_path)
    rc, line, err = run_cell(capsys, root, cells()[0], trace=1, seed=29)
    assert rc == 0, err
    chunks = [sp for sp in recs[0]["spans"] if sp.name == "sim.cycles"]
    assert chunks
    assert all(sp.args["graphed"] == 0 for sp in chunks)
    assert sum(sp.args["alloc_calls"] for sp in chunks) > 0
    assert "loop.graphed_pct" not in line["metrics"]
    assert "loop.host_us_per_cycle" in line["metrics"]

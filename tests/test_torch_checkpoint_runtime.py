"""The port's checkpoint (atomicity, retention, async) and
fault-tolerance primitives: the cases of tests/test_checkpoint_runtime.py
(but elastic resharding, which waits for the port's `ParallelCtx`) on
`repro_torch.checkpoint` and `repro_torch.runtime`, and checkpoints of
the same plain nested dict written by either package and read by the
other."""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as jax_ckpt  # noqa: E402
from repro_torch import tree as T  # noqa: E402
from repro_torch.checkpoint import (AsyncCheckpointer,  # noqa: E402
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.runtime import (StepWatchdog, Heartbeat,  # noqa: E402
                                 elastic_batch, retry)


def _tree(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": torch.from_numpy(rng.normal(size=(8, 4))).float(),
            "opt": {"m": torch.zeros((8, 4)),
                    "step": torch.tensor(7, dtype=torch.int32)},
            "blocks": [torch.ones((2, 3)),
                       torch.arange(5, dtype=torch.int32)]}


def _equal(got, want):
    got, want = T.leaves(got), T.leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_roundtrip(tmp_path):
    d = str(tmp_path / "ck")
    t = _tree()
    save_checkpoint(d, 10, t)
    assert latest_step(d) == 10
    got = restore_checkpoint(d, 10, T.tree_map(torch.zeros_like, t))
    _equal(got, t)


def test_retention_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    t = _tree()
    for s in (1, 2, 3, 4, 5):
        save_checkpoint(d, s, t, keep=2)
    steps = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert len(steps) == 2
    assert latest_step(d) == 5


def test_async_checkpointer(tmp_path):
    d = str(tmp_path / "ck")
    ck = AsyncCheckpointer(d)
    t = _tree()
    ck.save(3, t)
    ck.wait()
    assert latest_step(d) == 3
    got = restore_checkpoint(d, 3, T.tree_map(torch.zeros_like, t))
    _equal(got, t)


def test_tmp_dirs_not_trusted(tmp_path):
    d = str(tmp_path / "ck")
    t = _tree()
    save_checkpoint(d, 1, t)
    os.makedirs(os.path.join(d, "step_00000099.tmp0"))
    assert latest_step(d) == 1


def test_watchdog_flags_straggler():
    wd = StepWatchdog(window=16, factor=2.0)
    for _ in range(10):
        assert not wd.observe(1.0)
    assert wd.observe(5.0)
    assert wd.flagged == 1


def test_heartbeat(tmp_path):
    p = str(tmp_path / "hb.json")
    hb = Heartbeat(p, interval_s=100)
    hb.beat({"step": 5})
    import json
    with open(p) as f:
        data = json.load(f)
    assert data["step"] == 5
    hb.stop()


def test_elastic_batch():
    per, scale = elastic_batch(256, 16)
    assert per == 16 and scale == 1.0
    per, scale = elastic_batch(256, 12)   # lost 4 hosts
    assert per == 22 and scale == pytest.approx(264 / 256)


def test_retry():
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert retry(flaky, retries=4, backoff_s=0.01)() == "ok"
    assert len(calls) == 3


def test_retry_backoff_sequence(monkeypatch):
    """Delays follow exact exponential doubling from backoff_s, one
    sleep per failed attempt, none after the final raise."""
    from repro_torch.runtime import fault as rf
    slept = []
    monkeypatch.setattr(rf.time, "sleep", slept.append)
    calls = []

    def always_fails():
        calls.append(1)
        raise OSError("transient")

    with pytest.raises(OSError):
        retry(always_fails, retries=3, backoff_s=0.5)()
    assert calls == [1, 1, 1, 1]              # initial + 3 retries
    assert slept == [0.5, 1.0, 2.0]           # no sleep after last raise


def test_retry_exception_filtering(monkeypatch):
    """Exceptions outside `on` propagate immediately: no retry, no
    sleep."""
    from repro_torch.runtime import fault as rf
    slept = []
    monkeypatch.setattr(rf.time, "sleep", slept.append)
    calls = []

    def wrong_kind():
        calls.append(1)
        raise ValueError("a bug, not a transient")

    with pytest.raises(ValueError):
        retry(wrong_kind, retries=5, backoff_s=0.1)()
    assert calls == [1] and slept == []
    # ...and a custom `on` widens the net
    calls.clear()

    def flaky_value():
        calls.append(1)
        if len(calls) < 2:
            raise ValueError("transient here")
        return "ok"

    assert retry(flaky_value, retries=2, backoff_s=0.1,
                 on=(ValueError,))() == "ok"
    assert slept == [0.1]


def test_watchdog_factor_boundary():
    """Flagging is strict: step == factor x median is NOT slow, just
    above is; and nothing is flagged before 8 observations."""
    warm = StepWatchdog(window=16, factor=2.5)
    for _ in range(7):
        assert not warm.observe(100.0)        # < 8 samples: never slow
    assert warm.flagged == 0

    wd = StepWatchdog(window=16, factor=2.5)
    for _ in range(8):
        wd.observe(1.0)                       # window: 8 x 1.0, median 1.0
    assert not wd.observe(2.5)                # exactly factor x median
    assert wd.flagged == 0
    assert wd.observe(2.5 + 1e-9)             # just above
    assert wd.flagged == 1


def test_watchdog_uses_rolling_window():
    """Old samples age out of the deque: a regime change re-baselines
    the median instead of flagging forever."""
    wd = StepWatchdog(window=8, factor=2.0)
    for _ in range(8):
        wd.observe(1.0)
    assert wd.observe(10.0)                   # slow vs the 1.0 regime
    for _ in range(8):
        wd.observe(10.0)                      # window now all 10.0
    assert not wd.observe(10.0)               # re-baselined


def test_heartbeat_lifecycle_and_atomicity(tmp_path):
    p = str(tmp_path / "sub" / "hb.json")
    hb = Heartbeat(p, interval_s=100)
    assert hb.start() is hb                   # chainable; beats at start
    import json
    with open(p) as f:
        data = json.load(f)
    assert data["pid"] == os.getpid() and data["time"] <= time.time()
    hb.beat({"step": 12})
    with open(p) as f:
        assert json.load(f)["step"] == 12
    assert not os.path.exists(p + ".tmp")     # atomic tmp+replace
    hb.stop()
    hb._thread.join(timeout=5)
    assert not hb._thread.is_alive()


def test_async_snapshot_is_taken_before_the_write(tmp_path):
    """The tree is copied to host memory at save(): changing it in place
    while the writer runs does not reach the checkpoint."""
    d = str(tmp_path / "ck")
    ck = AsyncCheckpointer(d)
    t = _tree()
    want = T.tree_map(torch.clone, t)
    ck.save(1, t)
    with torch.no_grad():
        t["w"].add_(1.0)
        t["opt"]["m"].fill_(3.0)
    ck.wait()
    _equal(restore_checkpoint(d, 1, t), want)


def test_async_checkpointer_raises_the_writers_error(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save(1, _tree())
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                                 # raised once, then cleared


def test_restore_places_on_the_device_and_names_missing_leaves(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 2, _tree())
    got = restore_checkpoint(d, 2, _tree(), device="cpu")
    assert all(x.device.type == "cpu" for x in T.leaves(got))
    with pytest.raises(KeyError, match="extra"):
        restore_checkpoint(d, 2, dict(_tree(), extra=torch.zeros(1)))


def test_manifest_less_and_misnamed_dirs_not_trusted(tmp_path):
    """A step directory without a manifest (a crash before the commit) or
    with another name is neither the latest step nor pruned."""
    d = str(tmp_path / "ck")
    save_checkpoint(d, 1, _tree())
    os.makedirs(os.path.join(d, "step_00000050"))
    stale = os.path.join(d, "step_00000099.tmp0")
    os.makedirs(stale)
    with open(os.path.join(stale, "manifest.json"), "w") as f:
        f.write("{}")
    assert latest_step(d) == 1
    for s in (2, 3, 4):
        save_checkpoint(d, s, _tree(), keep=2)
    assert latest_step(d) == 4
    assert sorted(os.listdir(d)) == ["step_00000003", "step_00000004",
                                     "step_00000050", "step_00000099.tmp0"]


def _jax_tree():
    return jax.tree.map(lambda x: jnp.asarray(x.numpy()), _tree())


def test_port_reads_a_jax_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    jax_ckpt.save_checkpoint(d, 5, _jax_tree())
    assert latest_step(d) == 5
    _equal(restore_checkpoint(d, 5, _tree()), _tree())


def test_jax_reads_a_port_checkpoint(tmp_path):
    d = str(tmp_path / "ck")
    save_checkpoint(d, 6, _tree())
    assert jax_ckpt.latest_step(d) == 6
    got = jax_ckpt.restore_checkpoint(d, 6, _jax_tree())
    for a, b in zip(jax.tree.leaves(got), T.leaves(_tree())):
        assert np.asarray(a).dtype == b.numpy().dtype
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_leaf_names_equal_the_reference(tmp_path):
    """Each package writes the same file for each leaf."""
    mine, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    save_checkpoint(mine, 1, _tree())
    jax_ckpt.save_checkpoint(ref, 1, _jax_tree(), process_index=0)
    assert sorted(os.listdir(os.path.join(mine, "step_00000001"))) == \
        sorted(os.listdir(os.path.join(ref, "step_00000001")))

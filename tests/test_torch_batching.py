"""The port's DynamicBatcher against the JAX package's, on the same scripted
``batch_fn``: the same batches in the same order, the same results and
errors for each waiter, the same stats. Host-only (no device); results are
compared for equality, with no tolerance."""

import sys
import threading
import time
from concurrent.futures import Future

import pytest

from dgdm_histopath_torch.deployment.batching import DynamicBatcher as TorchBatcher
from dgdm_histopath_tpu.deployment.batching import DynamicBatcher as JaxBatcher

BATCHERS = [JaxBatcher, TorchBatcher]


def _held_then_burst(cls, fn, first, rest, max_batch, max_wait_ms=50):
    """``first`` occupies the device thread inside ``fn`` (held on a gate)
    while ``rest`` queue up behind it; then the gate opens. Returns (batcher,
    futures in submit order, the list of batches ``fn`` saw)."""
    calls, entered, gate = [], threading.Event(), threading.Event()

    def batch_fn(items):
        calls.append(list(items))
        entered.set()
        gate.wait(10)
        return fn(items)

    b = cls(batch_fn, max_batch=max_batch, max_wait_ms=max_wait_ms)
    futs = [b.submit(first)]
    assert entered.wait(10)
    futs += [b.submit(i) for i in rest]
    gate.set()
    return b, futs, calls


def _outcome(fut):
    try:
        return ("ok", fut.result(timeout=10))
    except Exception as exc:  # noqa: BLE001 - the outcome is compared
        return (type(exc).__name__, str(exc))


def _run_both(fn, first, rest, max_batch, **kw):
    """(outcomes, batches, stats) of each package's batcher on one script."""
    out = []
    for cls in BATCHERS:
        b, futs, calls = _held_then_burst(cls, fn, first, rest, max_batch, **kw)
        outcomes = [_outcome(f) for f in futs]
        b.close()
        out.append((outcomes, calls, dict(b.stats), b.mean_batch_size))
    return out


def test_coalesces_in_order_like_the_jax_batcher():
    jax_run, torch_run = _run_both(lambda items: [i * 10 for i in items], 0, range(1, 6),
                                   max_batch=5)
    assert torch_run == jax_run
    outcomes, calls, stats, mean = torch_run
    assert calls == [[0], [1, 2, 3, 4, 5]]
    assert outcomes == [("ok", i * 10) for i in range(6)]
    assert stats == {"batches": 2, "items": 6, "max_batch_seen": 5} and mean == 3.0


def test_batches_never_exceed_max_batch():
    jax_run, torch_run = _run_both(lambda items: list(items), 0, range(1, 10), max_batch=4)
    assert torch_run == jax_run
    assert [len(c) for c in torch_run[1]] == [1, 4, 4, 1]


def test_an_error_reaches_every_waiter():
    def bad(items):
        raise RuntimeError("boom")

    jax_run, torch_run = _run_both(bad, "a", ["b", "c"], max_batch=2)
    assert torch_run == jax_run
    outcomes, calls, stats, _ = torch_run
    assert outcomes == [("RuntimeError", "boom")] * 3
    # the batch of two failed and each item ran again on its own
    assert calls == [["a"], ["b", "c"], ["b"], ["c"]]
    assert stats["batches"] == 2 and stats["items"] == 3


def test_length_mismatch_fails_every_waiter():
    jax_run, torch_run = _run_both(lambda items: [], "a", ["b", "c"], max_batch=2)
    assert torch_run == jax_run
    outcomes = torch_run[0]
    assert [o[0] for o in outcomes] == ["RuntimeError"] * 3
    assert outcomes[0][1] == "batch_fn returned 0 results for 1 items"
    assert outcomes[1][1] == "batch_fn returned 0 results for 1 item"


def test_one_bad_item_does_not_fail_its_neighbours():
    def fn(items):
        if "poison" in items:
            raise ValueError("malformed graph")
        return [f"ok:{i}" for i in items]

    jax_run, torch_run = _run_both(fn, 0, [1, "poison", 3], max_batch=3)
    assert torch_run == jax_run
    assert torch_run[0] == [("ok", "ok:0"), ("ok", "ok:1"),
                            ("ValueError", "malformed graph"), ("ok", "ok:3")]


@pytest.mark.parametrize("cls", BATCHERS, ids=["jax", "torch"])
def test_items_behind_the_stop_marker_fail_fast(cls):
    gate = threading.Event()

    def fn(items):
        gate.wait(10)
        return list(items)

    b = cls(fn, max_batch=1, max_wait_ms=1)
    first = b.submit("a")
    time.sleep(0.05)
    stranded: Future = Future()
    b._q.put(None)                       # close()'s stop marker
    b._q.put(("late", stranded))         # a submit that raced it
    gate.set()
    assert first.result(timeout=10) == "a"
    with pytest.raises(RuntimeError, match="closed"):
        stranded.result(timeout=10)
    b._thread.join(timeout=10)
    assert not b._thread.is_alive()


@pytest.mark.parametrize("cls", BATCHERS, ids=["jax", "torch"])
def test_submit_after_close_raises_and_close_is_idempotent(cls):
    b = cls(lambda items: list(items), max_batch=4, max_wait_ms=1)
    assert b(7, timeout=10) == 7
    b.close()
    b.close()
    assert not b._thread.is_alive()
    with pytest.raises(RuntimeError, match="batcher is closed"):
        b.submit(1)
    assert b.stats == {"batches": 1, "items": 1, "max_batch_seen": 1}


@pytest.mark.parametrize("cls", BATCHERS, ids=["jax", "torch"])
def test_max_batch_below_one_is_refused(cls):
    with pytest.raises(ValueError, match="max_batch"):
        cls(lambda items: items, max_batch=0)


def test_many_threads_each_get_their_own_result():
    """32 client threads (more than the cores) against one batcher, with a
    short switch interval: every caller gets its own item back, and the stats
    count every item once."""
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        b = TorchBatcher(lambda items: [("r", i) for i in items], max_batch=8, max_wait_ms=2)
        got = {}

        def client(t):
            for j in range(20):
                got[(t, j)] = b((t, j), timeout=30)

        threads = [threading.Thread(target=client, args=(t,)) for t in range(32)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        b.close()
    finally:
        sys.setswitchinterval(old)
    assert got == {k: ("r", k) for k in got} and len(got) == 640
    assert b.stats["items"] == 640 and 1 <= b.stats["max_batch_seen"] <= 8
    assert b.stats["batches"] >= 640 / 8

"""``LocalBus.close`` against a publish in flight (threaded mode).

``publish`` copies the subscriber list under the bus lock and calls each
enqueuer outside it, so an enqueuer can run after ``close``. The sequence
here holds one enqueuer as ``publish`` holds it, closes the bus, then calls
it: the message must not be handled and no worker may be left running.
"""
import threading
import time

from gisnav_tpu_torch.nodes.bus import WORKER_NAME, LocalBus


def _workers_alive():
    return [t for t in threading.enumerate()
            if t.name == WORKER_NAME and t.is_alive()]


def test_enqueuer_held_across_close_drops_the_message():
    before = len(_workers_alive())
    bus, seen = LocalBus(async_dispatch=True), []
    bus.subscribe("t", seen.append)
    with bus._lock:  # what ``publish`` takes before it lets the lock go
        held = list(bus._subs["t"])
    bus.close()
    for enqueue in held:
        enqueue("after close")
    time.sleep(0.2)
    assert seen == []
    assert bus._workers == []
    assert len(_workers_alive()) == before


def test_worker_started_before_close_is_stopped():
    bus, seen = LocalBus(async_dispatch=True), []
    done = threading.Event()
    bus.subscribe("t", lambda m: (seen.append(m), done.set()))
    bus.publish("t", 1)
    assert done.wait(2.0)
    workers = [t for _, t in bus._workers]
    assert len(workers) == 1
    bus.close()
    assert not workers[0].is_alive()
    bus.publish("t", 2)  # no subscriber is left
    time.sleep(0.1)
    assert seen == [1]

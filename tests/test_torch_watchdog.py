"""The deadline logic of ``repro_torch.kernels.watchdog`` on the CPU, with
a fake event and a fake clock: a wait that the event ends returns, one
that outlasts the deadline raises ``KernelTimeout``. And
``chip_smoke.run_phase``'s deadline, in a child process: a phase that
outlasts it ends the process with exit code 1 and every thread's stack."""
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro_torch.kernels import watchdog


class FakeEvent:
    """Done after ``polls`` queries (never, for None)."""

    def __init__(self, polls):
        self.polls, self.queries = polls, 0

    def query(self):
        self.queries += 1
        return self.polls is not None and self.queries > self.polls


class FakeClock:
    """A clock that only the fake sleep moves."""

    def __init__(self):
        self.now, self.sleeps = 0.0, []

    def __call__(self):
        return self.now

    def sleep(self, s):
        self.sleeps.append(s)
        self.now += s


def _wait(event, clock, **kw):
    return watchdog.wait_event(event, clock=clock, sleep=clock.sleep, **kw)


def test_done_event_returns_at_once():
    clock = FakeClock()
    assert _wait(FakeEvent(0), clock) == 0.0
    assert clock.sleeps == []


@pytest.mark.parametrize("polls", [1, 5, 40])
def test_event_done_before_the_deadline_returns_the_wait(polls):
    clock, event = FakeClock(), FakeEvent(polls)
    waited = _wait(event, clock)
    assert event.queries == polls + 1 and len(clock.sleeps) == polls
    assert waited == pytest.approx(sum(clock.sleeps))
    assert waited < watchdog.DEADLINE_S


@pytest.mark.parametrize("deadline_s", [0.0, 0.05, 3.0])
def test_hung_event_raises_past_the_deadline(monkeypatch, deadline_s):
    monkeypatch.setattr(watchdog, "DEADLINE_S", deadline_s)
    clock = FakeClock()
    with pytest.raises(watchdog.KernelTimeout, match="ssd scan"):
        _wait(FakeEvent(None), clock, what="ssd scan")
    # it gave up within one capped poll of the deadline, not before it
    assert deadline_s < clock.now <= deadline_s + 2 * watchdog.MAX_POLL_S


def test_timeout_is_a_runtime_error():
    assert issubclass(watchdog.KernelTimeout, RuntimeError)


def _phase_child(body: str) -> subprocess.CompletedProcess:
    """Run ``body`` in a child Python that has imported chip_smoke with a
    phase deadline of 0.5 s."""
    code = textwrap.dedent(f"""
        import sys, time
        sys.path.insert(0, {str(Path(__file__).resolve().parents[1])!r})
        import chip_smoke
        chip_smoke.PHASE_DEADLINE_S = 0.5
    """) + textwrap.dedent(body)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=60)


def test_phase_past_its_deadline_ends_the_process():
    out = _phase_child("""
        chip_smoke.run_phase(time.sleep, 30)
        print("not reached")
    """)
    assert out.returncode == 1
    assert "not reached" not in out.stdout
    assert "Timeout" in out.stderr and "run_phase" in out.stderr


def test_phase_within_its_deadline_returns_and_disarms_it():
    out = _phase_child("""
        assert chip_smoke.run_phase(lambda x: x + 1, 41) == 42
        time.sleep(1.0)  # twice the deadline, after the phase
        print("alive")
    """)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "alive"


class NeverEvent:
    """A CUDA event whose work never finishes: ``record`` does nothing,
    ``query`` is always False."""

    def record(self, stream=None):
        pass

    def query(self):
        return False


class FakeStream:
    def wait_event(self, event):
        pass


def test_hung_save_device_phase_raises_kernel_timeout(monkeypatch, tmp_path):
    """The checkpoint writer waits for its stream's device phase through
    the watchdog: when that work never finishes, the writer raises
    ``KernelTimeout``, ``device_done`` (what the training loop waits on
    before its next step) carries it, and so does the save's result,
    instead of either hanging."""
    import contextlib

    import torch

    from repro_torch.core.cluster import SimCluster
    monkeypatch.setattr(watchdog, "DEADLINE_S", 0.05)
    cluster = SimCluster(tmp_path, n_nodes=2, device="cpu")
    try:
        tiered = cluster.tiered
        # the writer's CUDA path, on the CPU: a card checkpointer, its own
        # stream, and an event that never completes
        monkeypatch.setattr(tiered.checkpointer, "device",
                            torch.device("cuda", 0))
        monkeypatch.setattr(tiered, "_writer_stream", FakeStream)
        monkeypatch.setattr(torch.cuda, "Event", NeverEvent)
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda *a, **k: None)
        monkeypatch.setattr(torch.cuda, "stream",
                            lambda s: contextlib.nullcontext())
        ticket = tiered.save_async(1, {"w": torch.ones(4, 3)})
        with pytest.raises(watchdog.KernelTimeout, match="step 1"):
            ticket.device_done.result(timeout=30)
        with pytest.raises(watchdog.KernelTimeout):
            ticket.result(timeout=30)
        assert tiered.checkpointer.latest_step() is None
    finally:
        monkeypatch.undo()
        cluster.shutdown()

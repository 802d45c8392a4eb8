"""``testing.py::shared_result``, which lets the workers of one test run
compute each reference trajectory once: a worker that holds a key's lock
hands its result to the workers waiting on it, and a worker killed while
computing leaves a lock file that nobody waits for."""

import hashlib
import os
import signal
import subprocess
import sys
import tempfile
import textwrap
import threading
import time

import pytest

from scalecube_cluster_tpu_torch.testing import one_cpu_thread, shared_result

one_cpu_thread()

KEY = "test_torch_testing.key"


@pytest.fixture
def run_dir(tmp_path, monkeypatch):
    """A run of its own under a temporary directory of its own; returns
    the run's directory, where ``shared_result`` keeps its files."""
    run = f"shared-{os.getpid()}-{time.time_ns()}"
    monkeypatch.setenv("PYTEST_XDIST_TESTRUNUID", run)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    root = tmp_path / f"scalecube-torch-refs-{run}"
    root.mkdir()
    return root


def test_waiter_reads_the_holders_result(run_dir):
    """A second caller (another thread: each ``open`` takes its own lock)
    blocks while the first computes, then reads its result."""
    holding = threading.Event()

    def compute():
        holding.set()
        time.sleep(0.5)
        return 42

    got = {}
    holder = threading.Thread(target=lambda: got.update(holder=shared_result(KEY, compute)))
    holder.start()
    assert holding.wait(60), "the holder never took the lock"

    def waiter_compute():
        raise AssertionError("the waiter computed what the holder was computing")

    assert shared_result(KEY, waiter_compute) == 42
    holder.join(60)
    assert got == {"holder": 42}


# A worker that took KEY's lock and was killed before it wrote a result.
HOLDER = textwrap.dedent("""
    import fcntl, sys, time
    lock = open(sys.argv[1], "a")
    fcntl.flock(lock, fcntl.LOCK_EX)
    open(sys.argv[2], "w").close()
    time.sleep(600)
""")


def test_killed_holder_leaves_no_wait(run_dir):
    """A stale lock file, left by a holder killed while computing, costs
    the next caller no wait: it computes, and later callers read that."""
    lock = run_dir / f"{hashlib.sha1(KEY.encode()).hexdigest()}.lock"
    marker = run_dir / "holding"
    proc = subprocess.Popen([sys.executable, "-c", HOLDER, str(lock), str(marker)])
    deadline = time.monotonic() + 60
    while not marker.exists():
        assert proc.poll() is None and time.monotonic() < deadline, "no lock taken"
        time.sleep(0.02)
    proc.send_signal(signal.SIGKILL)
    proc.wait(timeout=60)
    assert lock.exists()
    t0 = time.monotonic()
    assert shared_result(KEY, lambda: 7) == 7
    assert time.monotonic() - t0 < 5.0
    assert shared_result(KEY, lambda: 8) == 7

"""Run a test file's JAX reference computations in a child process.

Under the tier-1 suite's six workers, JAX's exact path on the CPU (many
small operations, dispatched one by one or run in the thunks of a
compiled while loop) waits for thread pools in a busy machine. The child
runs it in one thread: XLA without its thread pool, JAX without
asynchronous dispatch, torch with one thread. A test calls
``run(__file__, tmp_path, *names)``; the test file ends with
``if __name__ == "__main__": serve(compute)``, where ``compute(name)``
returns a dict of numpy arrays. The results travel as an ``.npz`` under
the test's own ``tmp_path``, or, for references that several tests
share, once per test session (``shared``).

Under pytest-xdist the shared references live in one directory of the
session's run (``_session_dir``), and a test file may ``prefetch`` them
when it is collected: one helper process a session (``_prefetcher``)
then computes them, ``PREFETCH_SLOTS`` at a time and those collected
last first: xdist hands out the tests in collection order, so without it
a long child of a file collected near the end starts near the end of the
run and prolongs it. A reference that no one has computed yet when its
test asks is computed by that test, as without the helper.
"""

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
PREFETCH_SLOTS = 2      # children the helper runs at once
TIMEOUT = 900


def _child_env():
    env = {k: v for k, v in os.environ.items()
           if k != "PYTEST_XDIST_TESTRUNUID"}      # no prefetch in a child
    return dict(env, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
                JAX_CPU_ENABLE_ASYNC_DISPATCH="false", PYTHONPATH=str(REPO),
                XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                          "intra_op_parallelism_threads=1")


def run(test_file, tmp_path, *names, timeout=TIMEOUT):
    """{name: compute(name)} from a child process running `test_file`."""
    out = Path(tmp_path) / "jax_oracle.npz"
    part = out.with_suffix(".part.npz")
    proc = subprocess.run([sys.executable, str(test_file), str(part), *names],
                          env=_child_env(), capture_output=True, text=True,
                          timeout=timeout, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    os.replace(part, out)
    return _load(out, names)


def _session_dir():
    """The directory that the xdist workers of one run share (None
    outside xdist). The first worker to ask starts the session's helper,
    which also removes the directory when the run ends."""
    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    if uid is None:
        return None
    root = Path(tempfile.gettempdir()) / f"jax-oracle-{uid}"
    root.mkdir(parents=True, exist_ok=True)
    try:
        os.close(os.open(root / "helper", os.O_CREAT | os.O_EXCL))
    except FileExistsError:
        return root
    # stdin and stdout are the xdist worker's channel: the helper gets none
    subprocess.Popen([sys.executable, __file__, "--prefetch", str(root),
                      str(os.getppid())], cwd=str(REPO),
                     env=dict(os.environ, PYTHONPATH=str(REPO)),
                     stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                     stderr=subprocess.DEVNULL)
    return root


def _tag(test_file, names):
    return f"{Path(test_file).stem}-{'-'.join(names)}"


def shared(tmp_path_factory, test_file, *names, timeout=TIMEOUT):
    """``run`` once per test session: the first test that asks runs the
    child (or waits for the prefetch helper that runs it), and every later
    one, in any pytest-xdist worker, loads its result from the session's
    directory (a file lock makes the others wait while it runs)."""
    from filelock import FileLock

    root = _session_dir() or tmp_path_factory.getbasetemp()
    tag = _tag(test_file, names)
    out_dir = root / tag
    with FileLock(str(root / f"{tag}.lock")):
        if (out_dir / "jax_oracle.npz").exists():
            return _load(out_dir / "jax_oracle.npz", names)
        out_dir.mkdir(exist_ok=True)
        return run(test_file, out_dir, *names, timeout=timeout)


def prefetch(test_file, *names):
    """Ask the session's helper for ``shared(..., test_file, *names)``.
    Called when a test file is collected; does nothing outside xdist."""
    root = _session_dir()
    if root is None:
        return
    want = root / f"{_tag(test_file, names)}.want"
    try:
        fd = os.open(want, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return
    with os.fdopen(fd, "w") as f:
        json.dump({"file": str(test_file), "names": names,
                   "t": time.time()}, f)


def _prefetcher(root, session):
    """The helper: computes the wanted references, the last collected
    first, ``PREFETCH_SLOTS`` at a time, until the session's pytest
    process ends (or it is sent SIGTERM); then stops its children and
    removes the session's directory."""
    import shutil
    import signal

    from filelock import FileLock, Timeout

    children, taken, lock = set(), set(), threading.Lock()

    def wanted():
        items = []
        for p in root.glob("*.want"):
            try:
                items.append(json.loads(p.read_text()))
            except (OSError, ValueError):       # being written
                pass
        return sorted(items, key=lambda it: -it["t"])

    def compute(item):
        tag = _tag(item["file"], item["names"])
        out_dir = root / tag
        try:
            with FileLock(str(root / f"{tag}.lock"), timeout=0):
                if (out_dir / "jax_oracle.npz").exists():
                    return
                out_dir.mkdir(exist_ok=True)
                part = out_dir / "jax_oracle.part.npz"
                with lock:
                    proc = subprocess.Popen(
                        [sys.executable, item["file"], str(part),
                         *item["names"]], env=_child_env(), cwd=str(REPO),
                        stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                        stderr=subprocess.DEVNULL)
                    children.add(proc)
                try:
                    if proc.wait(timeout=TIMEOUT) == 0:
                        os.replace(part, out_dir / "jax_oracle.npz")
                except subprocess.TimeoutExpired:
                    proc.kill()
                with lock:
                    children.discard(proc)
        except Timeout:     # a test is computing it
            pass

    def slots():
        while True:
            with lock:
                todo = [it for it in wanted()
                        if _tag(it["file"], it["names"]) not in taken]
                if not todo:
                    return
                item = todo[0]
                taken.add(_tag(item["file"], item["names"]))
            compute(item)

    signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))
    try:
        last = None     # collection is over when the queue stops growing
        while _alive(session):
            now = sorted(p.name for p in root.glob("*.want"))
            if now == last:
                break
            last = now
            time.sleep(3)
        for _ in range(PREFETCH_SLOTS):
            threading.Thread(target=slots, daemon=True).start()
        while _alive(session):
            time.sleep(1)
    finally:
        with lock:
            for proc in children:
                proc.kill()
        shutil.rmtree(root, ignore_errors=True)


def _alive(pid):
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        pass
    return True


def _load(out, names):
    with np.load(out) as data:
        flat = {key: data[key] for key in data.files}
    return {name: {key.split(":", 1)[1]: val for key, val in flat.items()
                   if key.split(":", 1)[0] == name} for name in names}


def serve(compute):
    """The child's side: python TEST_FILE OUT.npz NAME [NAME ...]."""
    results = {}
    for name in sys.argv[2:]:
        results.update({f"{name}:{key}": np.asarray(val)
                        for key, val in compute(name).items()})
    np.savez(sys.argv[1], **results)


if __name__ == "__main__":
    if sys.argv[1:2] == ["--prefetch"]:
        _prefetcher(Path(sys.argv[2]), int(sys.argv[3]))

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
share, once per test session under its temporary directory (``shared``).
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def run(test_file, tmp_path, *names, timeout=900):
    """{name: compute(name)} from a child process running `test_file`."""
    out = Path(tmp_path) / "jax_oracle.npz"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               JAX_CPU_ENABLE_ASYNC_DISPATCH="false", PYTHONPATH=str(REPO),
               XLA_FLAGS="--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    part = out.with_suffix(".part.npz")
    proc = subprocess.run([sys.executable, str(test_file), str(part), *names],
                          env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
    os.replace(part, out)
    return _load(out, names)


def shared(tmp_path_factory, test_file, *names, timeout=900):
    """``run`` once per test session: the first test that asks runs the
    child, and every later one, in any pytest-xdist worker, loads its
    result from the session's temporary directory (a file lock makes the
    others wait while it runs)."""
    from filelock import FileLock

    uid = os.environ.get("PYTEST_XDIST_TESTRUNUID")
    base = tmp_path_factory.getbasetemp()
    root = base if uid is None else base.parent    # shared by the workers
    tag = f"{Path(test_file).stem}-{'-'.join(names)}-{uid}"
    out_dir = root / tag
    with FileLock(str(root / f"{tag}.lock")):
        if (out_dir / "jax_oracle.npz").exists():
            return _load(out_dir / "jax_oracle.npz", names)
        out_dir.mkdir(exist_ok=True)
        return run(test_file, out_dir, *names, timeout=timeout)


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

"""Run a test file's JAX reference computations in a child process.

Under the tier-1 suite's six workers, JAX's exact path on the CPU (many
small operations, dispatched one by one or run in the thunks of a
compiled while loop) waits for thread pools in a busy machine. The child
runs it in one thread: XLA without its thread pool, JAX without
asynchronous dispatch, torch with one thread. A test calls
``run(__file__, tmp_path, *names)``; the test file ends with
``if __name__ == "__main__": serve(compute)``, where ``compute(name)``
returns a dict of numpy arrays. The results travel as an ``.npz`` under
the test's own ``tmp_path``.
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
    proc = subprocess.run([sys.executable, str(test_file), str(out), *names],
                          env=env, capture_output=True, text=True,
                          timeout=timeout, cwd=str(REPO))
    assert proc.returncode == 0, proc.stderr[-4000:]
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

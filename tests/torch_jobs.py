"""The helper processes of the port's tests (tests/test_torch_*.py), started
in one way.

Those tests compute raytpu's references, run the examples and start gloo
ranks in processes of their own while the port's side runs in the pytest
process.  In the tier-1 run the same machine runs raytpu's own test files
beside them, and its longest files set when the run ends.  So every helper
here:

  * starts at ``NICE`` (10): the kernel gives pytest's own processes, and
    with them raytpu's files, the CPU first.  Only the helper is niced, never
    the pytest process, which goes on to run other files and could not
    raise its priority back;
  * runs one thread: torch's intra-op pool, and XLA:CPU's through ``NPROC``
    (read when the helper first builds its jax backend, after this module
    has set it; it sizes XLA:CPU's Eigen pool, 8 threads to 1 on an 8-CPU
    machine, where ``XLA_FLAGS``'s ``--xla_cpu_multi_thread_eigen=false``
    leaves 8 threads and a matrix product on several cores).

A test file asks ``pool`` for its reference workers and ``popen`` for its
subprocesses, and starts processes of its own (gloo ranks) from a thread of
``niced_threads``: a process inherits the nice value of the thread that
starts it.  Each file sizes its own pool.  The references are the same
programs as before, on fewer threads and at a lower priority.
"""

import multiprocessing
import os
import subprocess
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

#: the nice value of every helper
NICE = 10
#: torch's OpenMP pool and XLA:CPU's pool on one thread
ONE_THREAD = {"OMP_NUM_THREADS": "1", "NPROC": "1"}


def _start_helper(initializer):
    """The first thing a pool's helper runs: nice, one thread, jax on the
    CPU, then the file's own ``initializer``."""
    os.nice(NICE)
    os.environ.update(ONE_THREAD)
    import jax
    import torch

    torch.set_num_threads(1)
    jax.config.update("jax_platforms", "cpu")
    if initializer is not None:
        initializer()


def pool(workers, initializer=None):
    """A pool of ``workers`` spawned helpers, each niced and on one thread,
    that run ``initializer()`` first."""
    return ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context("spawn"),
                               initializer=_start_helper, initargs=(initializer,))


def niced_threads(workers=1):
    """Threads at ``NICE``: a subprocess one of them starts (``Popen``, the
    ranks of ``parallel.launch.spawn``) starts niced; the calling thread
    keeps its own priority."""
    return ThreadPoolExecutor(workers, initializer=os.nice, initargs=(NICE,))


def popen(args, **kwargs):
    """``subprocess.Popen(args, **kwargs)`` as a helper: niced, on one thread."""
    with niced_threads() as th:
        return th.submit(subprocess.Popen, args, env={**os.environ, **ONE_THREAD},
                         **kwargs).result()

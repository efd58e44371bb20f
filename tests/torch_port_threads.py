"""An autouse fixture for the port's CPU tests: torch's CPU ops run on one
thread, the calling one.

torch's CPU ``exp`` is MKL's ``vmsExp`` in high-accuracy mode, bit for
bit, split across torch's OpenMP threads.  The first such call of a
process sometimes comes back wrong in one thread's share of the rows
(relative errors up to 1.49e-4, three times the worst of the library's
least accurate mode), while every later call is exact: a race among the
threads' first calls.  ``tests/diag_torch_port.py exp-threads`` shows it
in a few percent of fresh processes at 8 threads, with or without JAX run
first, and never on a second call.  That is how
``test_mlp2_plain_matches_jax_wide[elu-elu-float32]`` failed in a full
``-n 6`` run (max error 1.08e-4 against 2e-5, in the calling thread's
rows).  At one thread, 0 of 1440 fresh processes showed it, against 33
of 1440 at 8 threads.

Import it into a test module to apply it there::

    from torch_port_threads import one_torch_thread  # noqa: F401
"""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)

"""Caps torch's intra-op CPU threads in the port's test processes.

The whole suite runs under ``pytest -n 6 --dist loadfile`` on hosts of
8 cores, and each worker imports every test module at collection. torch's
default takes a thread per core in every worker, which starves the JAX
package's timing tests (a writer lease of 40 ms that a heartbeat thread
must renew). The port's CPU tests run small tables, so one thread a
worker costs them little. Every ``tests/test_torch_*.py`` and
``tests/torch_*.py`` module imports this one first. ``chip_smoke.py``
imports some of the helpers too; outside pytest the cap is not applied,
so its cpu sessions keep torch's own thread count.
"""

import sys

import torch

INTRA_OP_THREADS = 1

if "pytest" in sys.modules:
    torch.set_num_threads(INTRA_OP_THREADS)

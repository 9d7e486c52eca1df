"""Standalone distributed worker entry (see ``parallel/distributed.py``).

A separate module (not re-exported by the package) so ``python -m`` can run
it without runpy double-import warnings; all logic lives in
``distributed._worker_main``.
"""
from jstsp19.parallel.distributed import _worker_main

if __name__ == "__main__":
    _worker_main()

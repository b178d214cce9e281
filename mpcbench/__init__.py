"""The benchmark of the PyTorch and CUDA port, ``libmpc_tpu_torch``.

Run one cell with ``python3 -m mpcbench.run`` (see ``run.py``); the cells are
in ``BENCHMARK.json`` at the root of the repository."""

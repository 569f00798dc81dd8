"""The benchmark of the PyTorch and CUDA port, ``fastk_tpu_torch``.

    python3 -m kbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Each cell of ``BENCHMARK.json`` names a configuration (``configs/``: the
sample and the job's memory) and a traffic mix (``traffic/``: the job's flags
and which inputs it reads). The harness makes the inputs from the seed
(``gen``), times whole ``fastk`` jobs through the port's CLI entry in a closed
loop, and judges the last job's output files against a plain reference
(``reference``). Per-layer metrics are small readers under ``metrics/``,
found by their names in ``BENCHMARK.json``. A cell of more than one chip runs
the port's multi-process CLI, one process a card, whose other ranks
``ranks`` starts and keeps for the window.

Nothing here imports JAX or the JAX package ``fastk_tpu``.
"""

"""The port's benchmark: one cell (a configuration under a traffic mix) per
run, found by name from ``BENCHMARK.json``.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` prints one JSON line. Configurations, traffic mixes,
drivers, references and metric readers are files of their own under this
directory, found by the names ``BENCHMARK.json`` and the configuration and
traffic files give. Nothing here imports JAX or the JAX package.
"""

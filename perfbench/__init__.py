"""Serving benchmark of ``repro_torch`` on one NVIDIA H100.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json``. Everything that
belongs to one configuration, traffic mix, cell or per-layer metric is
a file of its own, found by the name ``BENCHMARK.json`` gives it:

  configs/<config>.json       the model as it is run, and its source
  traffic/<mix>.json          the parameters the one generator reads
  cells/<cell>.json           slots, cache depth, rate, correctness limit
  layer_metrics/<metric>.py   a reader with ``read(ctx)``
  reference/<module>.py       the plain fp32 model a configuration names
"""

"""portbench: the benchmark of tetsim_torch, the PyTorch and CUDA port.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the repository's ``BENCHMARK.json`` once
on the card and prints one JSON line.  A cell names a configuration
(``configs/<config>.json`` with its scene builder ``configs/<config>.py``
and its plain reference ``reference/<config>.py``) and a traffic mix
(``traffic/<mix>.json``, read by the one generator in ``lib/loop.py``);
each metric has a reader of its own in ``metrics/<metric>.py`` and each
cell the limits of its comparison with the reference in
``limits/<cell>.json``.  The harness finds every one of them by name, so
a cell, a configuration, a mix or a metric is added by adding files.
``calibrate.py`` reads the port's and the control's numbers that the
limits are set from.
"""

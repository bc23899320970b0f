"""What every cell shares: finding a cell's files by name (``cells``), the
scenes over tetsim_torch's World API (``scenes``), the traffic generator
(``loop``), the reading of the profiler's trace (``trace``), the frozen
work counts and peaks (``work``) and the comparison that decides
``correct`` (``verdict``)."""

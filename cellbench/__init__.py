"""The port's benchmark: one process times one cell of ``BENCHMARK.json``.

A cell is a configuration under a traffic mix.  Everything that belongs to
one of them sits in files of its own, found by name: ``configs/<config>.json``
(the sizes as run), ``workloads/<cell>.json`` (the traffic kind and its
parameters), ``traffic/<kind>.py`` (the driver of that kind) and
``metrics/<metric>.py`` (the reader of one per-layer metric).  The yardstick
(the generators of inputs, the counts of work, the peaks, the plain
references under ``reference/``) lives here too and imports nothing of the
program.  See ``README.md``.
"""

"""Plan-chain invariants for the port (copy of ``repro.analysis.invariants``).

Only :mod:`~repro_torch.analysis.invariants` is ported: the ``validate()``
methods of graph, traffic, partition, routing and block synapses
delegate to it.  The reference's lint registry and traced lints wait.
"""

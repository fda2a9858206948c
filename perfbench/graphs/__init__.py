"""Graph generators, one module a generator, found by file.

A configuration names its generator by ``"generator"``; the harness
loads ``graphs/<generator>.py`` (:func:`perfbench.generators.generate`).
Each module has ``n_nodes(cfg) -> int`` and ``edges(cfg, gen, device)
-> (src, dst)``: int64 endpoint tensors of the undirected draw on
``device``, with all their randomness from the ``torch.Generator``
``gen``.  Symmetrisation, weights, sources and labels are shared by
every graph and stay in :mod:`perfbench.generators`.  Adding a graph
adds a file here and a configuration that names it.
"""

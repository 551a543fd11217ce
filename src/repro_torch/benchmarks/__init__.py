"""The paper simulator's benchmarks on the port (copies of the
reference's ``benchmarks/`` rows that need no JAX): Fig 2/7/8
(``paper_figures``), the MARS design-point ablations (``ablations``) and
the KV-cache rows that replay traces through ``core.dram.simulate``
(``kvcache_sim``); ``run`` prints them as ``name,us_per_call,derived``
CSV."""

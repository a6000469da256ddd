"""The benchmark's own library: traffic, weights, the decoder family's plain
reference, the comparison that decides ``correct``, FLOP and byte counts,
the profiler reading. Nothing here imports the program under test
(``repro_torch``); only ``drivers``, ``run.py`` and each family's
``program_config`` do. Nothing imports JAX or the JAX package."""

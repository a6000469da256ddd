"""The benchmark's own library: traffic, weights, the plain reference, the
comparison that decides ``correct``, FLOP and byte counts, the profiler
reading. Nothing here imports the program under test (``repro_torch``) but
``drivers`` and ``run.py``; nothing imports JAX or the JAX package."""

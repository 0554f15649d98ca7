"""The benchmark's own code: loading cells by name, traffic, weights, FLOP
and byte counts, the plain reference, the judge and the trace reader.

Nothing here imports the JAX package; only :mod:`harness.port` and the
drivers import the PyTorch port (``repro_torch``), and
:mod:`harness.reference` and :mod:`harness.ctr_reference` import
neither.
"""

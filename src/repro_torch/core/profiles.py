"""Layer-profile constants (the part of ``repro.core.profiles`` the
parameter-server telemetry needs).

The cost model profiles each layer on a small batch of ``B_o`` examples
(paper §4.1) and scales its times by the training batch;
``repro_torch.ps.telemetry.PSTelemetry.embedding_odt`` reports measured
embedding-layer times per such window.  The profiles themselves wait for
the scheduler slice (ROADMAP.md queue 1 item 9).
"""

#: small profiling batch size ``B_o`` (paper §4.1)
B_O = 64

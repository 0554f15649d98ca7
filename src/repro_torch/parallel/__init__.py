"""Parallel building blocks of the port: the parameter-server sparse
embedding path (``ps``).  The mesh, activation and pipeline layers wait
for the multi-device slice (ROADMAP.md queue 1 item 12)."""

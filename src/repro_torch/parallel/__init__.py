"""Parallel building blocks of the port: the reference's sharding rules as
DTensor placements (``sharding``), activation layouts on an active mesh
(``act``), the HeterPS stage pipeline (``pipeline``) and the
parameter-server sparse embedding path (``ps``)."""

"""Host-side control of the port (admission policy)."""

"""Host-side control of the port: the admission policy, and the resource
types and profile constants the parameter-server telemetry reports in."""

"""Traffic drivers: one module a ``kind`` of traffic file."""

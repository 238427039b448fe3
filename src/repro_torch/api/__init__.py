"""Store surface of the port: value types, the in-memory container
backend, and the session-oriented ``DedupStore``."""

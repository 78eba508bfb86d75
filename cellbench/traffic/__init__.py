"""Traffic drivers: one module a traffic kind, ``<kind>.py``."""

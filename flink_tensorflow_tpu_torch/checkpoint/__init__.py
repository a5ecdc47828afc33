"""Checkpoint persistence of the port (``checkpoint/store.py``)."""

"""The benchmark's plain reference (see ``host.py``)."""

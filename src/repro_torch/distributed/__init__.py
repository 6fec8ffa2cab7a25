"""Segment sharding of the relation engine (docs/DESIGN.md §9), and the
training loop's fault tolerance (``fault.py``)."""

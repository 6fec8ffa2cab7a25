"""Segment sharding of the relation engine (docs/DESIGN.md §9)."""

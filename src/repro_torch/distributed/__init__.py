"""Cluster-level state machines of the port (DESIGN.md §5, §14)."""

"""Process shape and work partitioning (single process in this port)."""

"""Parallel helpers of the port (single device in this slice)."""

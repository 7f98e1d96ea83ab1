"""Parallel helpers of the port: sharding specs and placement
(``sharding``), the context-parallel decode attention
(``decode_attention``)."""

"""Parallel execution: the expert-parallel world (``sharding``), its
collectives and the MoE fabrics."""

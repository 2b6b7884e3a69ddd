"""Memory budget (reference src/memory/, SURVEY.md §2.8): hard-limit
budget with reserved pools. On the device side the analogous budget is
device-memory capacity for arrays (tracked by the vector engine's capacity
planning); this module covers the host side."""

from turdb_tpu.memory.budget import MemoryBudget  # noqa: F401

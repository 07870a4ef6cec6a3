"""Host-side utilities of the port (the TPC-H generator)."""

"""Host utilities of the port (results files)."""

"""NumPy oracles of the port, independent of its torch code:
``filters_golden`` (the 8 filter variants)."""

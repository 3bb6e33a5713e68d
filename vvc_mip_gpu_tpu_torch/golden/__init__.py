"""NumPy and pure-Python oracles of the port, independent of its torch
code: ``reference_model`` (the vectorized golden model of the whole cost
search), ``scalar_oracle`` (one CU and one mode at a time, per sample)
and ``filters_golden`` (the 8 filter variants)."""

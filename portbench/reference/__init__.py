"""The benchmark's plain reference: the MIP search's costs and the filters
in plain PyTorch, with its own tables and weights.  It imports nothing of
the measured program."""

"""The benchmark's count of the minSadHad combine, min(2 SAD, SATD) of
every cost, with the fixed H100 peaks of ``portbench/roofline.py``.

Counts what the function needs, whatever runs it (torch passes after the
cost kernels, or the kernels themselves): per cost one SAD and one SATD
read once and one minSadHad written once, int32, and 2 operations (a
doubling and a minimum), which never bind.
"""

from __future__ import annotations

from portbench.reference.tables import PER_CTU, num_ctus
from portbench.roofline import bound_ms


def combine_work(width: int, height: int, batch: int) -> tuple[int, int]:
    """(operations, bytes) of one batch's combine."""
    costs = batch * num_ctus(width, height)[2] * PER_CTU
    return 2 * costs, 3 * costs * 4


def combine_bound_ms(width: int, height: int, batch: int) -> float:
    return bound_ms(*combine_work(width, height, batch))

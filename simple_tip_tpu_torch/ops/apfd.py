"""Average Percentage of Fault Detection (own copy of the JAX package's host APFD).

``1 - sum(fault_orders) / (k*n) + 1/(2n)`` where fault orders are the 1-based
ranks of misclassified samples in the prioritized order.
"""

from typing import List, Union

import numpy as np


def apfd_from_order(is_fault, index_order: Union[List[int], np.ndarray]) -> float:
    """APFD of one prioritization order given the per-sample fault mask."""
    is_fault = np.asarray(is_fault)
    if is_fault.ndim != 1:
        raise ValueError("only unique faults (a 1-D fault mask) are supported")
    ordered_faults = is_fault[np.asarray(index_order)]
    fault_indexes = np.where(ordered_faults == 1)[0]
    k = np.count_nonzero(is_fault)
    n = is_fault.shape[0]
    # +1: first sample has index 0 but rank 1
    sum_of_fault_orders = np.sum(fault_indexes + 1)
    return 1 - (sum_of_fault_orders / (k * n)) + (1 / (2 * n))

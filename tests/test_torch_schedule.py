"""The port's copy of ``repro/core/schedule.py``: the same per-client batch
counts give the same alternate-client (AC) and alternate-minibatch (AM)
orders and the same dense ``schedule_array``, empty and unequal lists
included."""

import numpy as np
import pytest

from repro.core import schedule as J
from repro_torch.core import schedule as T

COUNTS = [[], [0], [0, 0, 0], [1], [3], [2, 2, 2], [4, 1, 3], [0, 2, 0, 5],
          [5, 2, 3, 1, 4], [1, 0, 7, 2, 2]]


@pytest.mark.parametrize("name", ["ac", "am"])
@pytest.mark.parametrize("n_batches", COUNTS, ids=str)
def test_orders_and_arrays_equal_repro(name, n_batches):
    assert T.SCHEDULES[name](list(n_batches)) == \
        J.SCHEDULES[name](list(n_batches))
    a, b = T.schedule_array(name, n_batches), J.schedule_array(name,
                                                                n_batches)
    assert a.dtype == b.dtype == np.int32
    assert a.shape == b.shape == (sum(n_batches), 2)
    np.testing.assert_array_equal(a, b)


def test_am_interleaves_and_drops_exhausted_clients():
    assert T.alternate_minibatch([2, 0, 3]) == [(0, 0), (2, 0), (0, 1),
                                                (2, 1), (2, 2)]
    assert T.alternate_client([2, 0, 1]) == [(0, 0), (0, 1), (2, 0)]

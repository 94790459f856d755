"""The control of ``correct``: the reference with the configuration's
guarantee broken, put in the program's place.

The configurations guarantee exact answers over the whole served snapshot.
The control answers from the release before it: every sequence of the
newest collection day is missing, as a server would answer that swapped
its snapshot late or cached answers across a swap. The comparison has to
find it wrong (``benchmark/tests/test_bench_control.py``; at the cells' own
sizes ``benchmark/control.py``).
"""

from __future__ import annotations

from .silo import Reference, Test


class StaleReference(Reference):
    def select(self, node):
        newest = self.day.max()
        return self._and([self._select(node),
                          Test(lambda x: self.day[x] < newest)])

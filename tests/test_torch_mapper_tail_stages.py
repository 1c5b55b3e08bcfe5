"""The mapper's tail stages 5-8 on ``tests/test_colmap_db.py``'s ring
database with stage 5 or stage 8 left out while the others run:
``xmtpu_torch`` on the host against ``xmtpu`` (stages 6 and 7:
``tests/test_torch_mapper_tail_ring.py``).  Without stage 5 the points
enter stage 6 untriangulated (NaN), so its LM steps are all rejected and
stage 7 triangulates from scratch, in both packages.  Tolerances as in
``tests/test_torch_mapper_tail.py``.
"""

import pytest

from tests.test_torch_mapper_tail import TAIL, _solve_both
from tests.test_torch_mapper_tail_ring import _ring_db


@pytest.mark.parametrize("flag", ["skip_global_positioning",
                                  "skip_pruning"])
def test_stage_5_or_8_skipped_matches(tmp_path, flag):
    _solve_both(_ring_db(tmp_path, 9, 5, 30), {**TAIL, flag: True})

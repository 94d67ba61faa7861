"""The control on the card: the cell's control (`checks/<cell>.json`
"control": the reference in TF32) in the program's place fails the
comparison that the program passes (run on the card; `vo_bench/control.py`
gives the readings at the cells' own size)."""

import pytest
import torch

from vo_bench import run


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kitti00_stereo.batch_cruise",
                                      "kitti00_mono.batch_urban"])
def test_the_control_fails_and_the_program_passes(card, workload):
    r = run.Run(workload, 2**31 + 99, 8.0, False, device=card)
    r.setup()
    r.window()
    r.free_program()
    limits = r.spec["limits"]
    assert run.judge(r.check(), limits)[0] is True
    assert run.judge(r.check(limits["control"]), limits)[0] is False
    torch.cuda.empty_cache()

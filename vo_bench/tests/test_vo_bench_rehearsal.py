"""A CPU rehearsal of a cell at a small crop: set-up, window and check run
end to end and print the result line the contract asks for."""

import pytest

from vo_bench import run
from vo_bench.tests._small import run_cell


@pytest.mark.parametrize("workload", ["kitti00_stereo.batch_cruise", "kitti00_mono.batch_urban"])
def test_rehearsal_at_a_small_crop(capsys, workload):
    res, err = run_cell(capsys, workload, with_err=True, frames=60 if "mono" in workload else 40)
    assert " in 1 spans at calls" in err  # a span of the window was replayed and compared
    assert list(res) == ["correct", "attempted", "failed", "metrics", "device", "checks"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] > 0
    assert set(res["metrics"]) == {"fps", "setup_s"}
    assert all(m["value"] > 0 for m in res["metrics"].values())
    limits = run.cell_spec(workload)["limits"]["limits"]
    assert {k: v["limit"] for k, v in res["checks"].items()} == limits


def test_no_card_no_result(capsys, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "kitti00_stereo.batch_cruise", "--seed", "1", "--seconds", "1", "--trace", "0"])
    assert rc != 0
    assert capsys.readouterr().out == ""

"""driver.unspanned_ms_per_frame: host ms of the pipelines' `vo.entry` outside its stage spans
(upload, rectification, the batch loop, the one readback and its wait, `_record`), over the
traced window's frames; None where the trace's count of `vo.entry` is not the program's."""

from vo_bench.stages import unspanned_ms_per_frame


def read(run):
    return unspanned_ms_per_frame(run)

"""The backward of a detector training step (detection/train.py:
make_det_train_step: autograd's backward and the None-to-zeros fill):
the mean over the traced part of the window of the program span
"train_step.backward" (utils/profiling.py: span; the name every train
step of the port gives its backward, which backward_ms.train reads in the
MGAR cells), its device time (CUDA events), or its host time where there
is no card.

This reader imports the program (``span_records``) inside ``read``, after
the checks that find nothing to read; a program without spans gives None.
"""

SPAN = "train_step.backward"


def read(rec):
    if rec.get("loop") != "train":
        return None
    try:
        from multimodal_gar_tpu_torch.utils.profiling import span_records
    except ImportError:                      # a program without spans
        return None
    xs = [r["host_ms"] if r["device_ms"] is None else r["device_ms"]
          for r in span_records().records if r["name"] == SPAN]
    return sum(xs) / len(xs) if xs else None

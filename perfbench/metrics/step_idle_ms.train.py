"""step_idle_ms.train (ms): the device's idle time while the host is inside
``mapf.train.step`` (``train/train_step.make_train_step``'s step: the
micro-batches' forwards and backwards, the clip and AdamW), a training
iteration.  Layer: ``train/train_step``.  Moves ``train_samples_per_s``.  No
device operation or no ``mapf.train.step`` span in the window: None."""

from perfbench import spans


def read(trace):
    return spans.idle_ms(trace, spans.span_intervals(trace, "mapf.train.step"), "iterations")

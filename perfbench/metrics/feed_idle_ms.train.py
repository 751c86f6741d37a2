"""feed_idle_ms.train (ms): the device's idle time while the host is inside
the shard feed's spans (``mapf.data.batch``: a batch's slices, casts and
reshapes; ``mapf.data.load_shard``: reading and permuting a shard; their
union), a training iteration.  Layer: ``train/data.ArrowShardStream``.
Moves ``train_samples_per_s``.  No device operation or no ``mapf.data.``
span in the window: None."""

from perfbench import spans


def read(trace):
    return spans.idle_ms(trace, spans.span_intervals(trace, prefix="mapf.data."), "iterations")

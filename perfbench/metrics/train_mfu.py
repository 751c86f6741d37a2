"""train_mfu (%): the products a last-token loss needs for every sample of the
training window (``frozen.train_model_flops``: the thinned forward and head,
and a backward of twice that, no recompute), over the window's time and the
card's dense bf16 peak.  Layer: the whole training iteration.  Moves
``train_samples_per_s``."""

from perfbench import frozen


def read(trace):
    samples = trace.counts.get("samples")
    if not samples or trace.window_s <= 0:
        return None
    return 100.0 * samples * frozen.train_model_flops(trace.config) / trace.window_s / frozen.PEAK_BF16

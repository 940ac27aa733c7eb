"""The listener's recurrences' share of their roofline in the traced
training steps, %: the least time of their forward and backward (the
larger of the operations at the configuration's dense peak and the bytes
at HBM's rate, from the reference module's `rnn_work` on the padded
shapes that ran) over the device time of the kernels that the
recurrences the program ran launched, forward and backward, whatever
implements them (drivers/train_loader_rnn.rnn_device_s)."""

from bench_torch import harness, work


def read(run):
    t = run.traced
    calls = run.spans.get("frontend.traced")
    plain = harness.reference(run.config)
    if t is None or not calls or not hasattr(plain, "rnn_work"):
        return None
    device_s = sum(t.get("rnn_device_s", {}).values())
    if device_s <= 0:
        return None
    least = 0.0
    for rows, _, frames in calls:
        ops, bytes_ = plain.rnn_work(run.values, rows, frames)
        least += max(ops / work.peak(run.values),
                     bytes_ / work.HBM_BYTES_PER_S)
    return 100.0 * least / device_s

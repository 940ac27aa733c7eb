"""Share of the listener's BiRNN frame-steps in the window that ran over
padding, %: 100 x (1 - the real frame-steps of the rows fed, through the
reference module's frame arithmetic, / the program's
`las.listener.rnn_frames` counter over the window's steps).  What packing
or finer bucketing would take away (drivers/train_loader_rnn.py)."""


def read(run):
    counted = run.counters.get("listener.rnn_frames")
    real = run.counters.get("listener.real_frames")
    if not counted or real is None:
        return None
    return 100.0 * (1.0 - real / counted)

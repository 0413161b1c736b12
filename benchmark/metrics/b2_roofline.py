"""``b2_roofline.<kind>``: the best-fit kernel B2's share of its
roofline: the least time its launches need at the card's published
peaks (``work.ffd_work(best_fit=True)`` of the lanes each launch solved,
3.35 TB/s and 67 TFLOP/s f32) over the device time of
``greedy_kernel<true, ...>`` in the profiled calls, in percent. Nothing
to read where no launch could be told apart."""


def read(run, name):
    if name.split(".", 1)[-1] != run.kind or run.b2 is None:
        return None
    bound_s, spent_s = run.b2
    if spent_s <= 0 or bound_s <= 0:
        return None
    return 100.0 * bound_s / spent_s

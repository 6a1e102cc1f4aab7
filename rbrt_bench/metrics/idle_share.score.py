"""Share of the traced window in which no operation ran on the device, in
percent."""


def read(trace):
    return 100.0 * trace.idle_share

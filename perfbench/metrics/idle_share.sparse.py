"""Share of the traced window in which no operation ran on the device."""


def read(m):
    return None if m.trace is None else m.trace.idle_share()

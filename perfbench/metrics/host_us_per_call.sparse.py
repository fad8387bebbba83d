"""The host's time in one staged call (the harness's clock around each
call), over the calls of the window the profiler did not trace. Where the
device is behind, a full launch queue makes the host wait inside the call,
and that wait is counted."""


def read(m):
    return m.rec.get("host_us_per_call")

"""Generated tokens that reached the host in the window, per second."""


def read(m):
    return m.rec["window_tokens"] / m.rec["window_s"]

"""Device time of the operations launched under MLA's spans inside the
prefill spans, per prefill."""


def read(m):
    tr = m.trace
    return None if tr is None else tr.ms_per(tr.under("mla", "prefill"), "prefill")

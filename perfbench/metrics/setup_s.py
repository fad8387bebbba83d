"""Process start to the first timed call: imports, the kernels loaded from
the build, inputs and weights made from the seed, staging, warm-up."""


def read(m):
    return m.setup_s

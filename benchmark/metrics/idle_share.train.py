"""% of the traced training window in which no kernel and no copy ran on the
device."""


def read(r):
    return r.idle_share("train")

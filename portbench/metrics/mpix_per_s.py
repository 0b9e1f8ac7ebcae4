"""``mpix_per_s`` (MP/s, host clock): the pixels of every request completed
in the window over the window's seconds, from the first call's start to the
last completion observed."""

from portbench.harness.record import rate_mpix_per_s


def read(run):
    return rate_mpix_per_s(run)

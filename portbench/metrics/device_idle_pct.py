"""``device_idle_pct`` (%, device trace): the share of the traced slice in
which no kernel, copy or fill ran on the card (100 less the union of their
intervals over the slice)."""

from portbench.harness.trace import idle_pct


def read(run):
    return idle_pct(run.trace)

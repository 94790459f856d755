"""mutations_roofline_pct: the time of the window's Mutations reductions'
bytes at the card's published bandwidth (benchmark/roofline_mutations.py:
the bytes of each alphabet's query counted from the corpus over every
partition, times the port's count of the queries it reduced on the card)
over K2's and K3's time on the card, in the lineage cell: an upper bound
on their share of the bandwidth, since a query need not read the
partitions its filter leaves empty."""

from benchmark import roofline_mutations


def counters(engine):
    return roofline_mutations.counters(engine)


def read(run):
    return roofline_mutations.mutations_roofline_pct(run)

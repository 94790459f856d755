"""groupby_roofline_pct: the time of the window's group-bys' least bytes
at the card's published bandwidth (benchmark/roofline_groupby.py: per
query the filter, one code per genome at the least width of its key space
and a count per group, counted from the corpus) over K9's time on the
card, in the variant-page cell: an upper bound on K9's share of the
bandwidth, since a filter that selects few genomes need not read every
code. The group-bys are those answered inside the window, by the column
their kind groups by (traffic/variant_page.json)."""

from benchmark import roofline_groupby
from benchmark.traffic.generator import load_mix

PREFIX = "least_group_bytes."


def counters(engine):
    """The least bytes of a group-by by each column, which the database
    keeps (constant over the window)."""
    least = getattr(engine.db, "least_group_bytes", None) or {}
    return {PREFIX + column: n for column, n in least.items()}


def read(run):
    least = {name[len(PREFIX):]: closed for name, (_, closed)
             in run.counters.items() if name.startswith(PREFIX)}
    columns = {kind["name"]: kind["action"]["groupByFields"]
               for kind in load_mix("variant_page")["kinds"]
               if kind["action"].get("groupByFields")}
    grouped: dict = {}
    for r in run.records:
        fields = columns.get(r.kind)
        if fields and r.ok and r.end <= run.t1:
            (column,) = fields
            grouped[column] = grouped.get(column, 0) + 1
    return roofline_groupby.groupby_roofline_pct(run, least, grouped)

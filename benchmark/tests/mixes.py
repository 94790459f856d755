"""A mix for the tests alone: every action the reference answers (counts,
some narrowed by country and date; groups by date and by country;
Mutations; Details), in an open loop. No cell runs it: the reference and
the faults of those actions stay proven for a cell that a later change
brings with a mix of its own."""

ACTIONS = {
    "loop": {"kind": "open", "rate_per_s": 60, "workers": 8},
    "positions": {"kind": "uniform"},
    "has_mutation_share": 0.5,
    "date_span_days": [1, 14],
    "kinds": [
        {"name": "count", "share": 0.40, "action": {"type": "Aggregated"},
         "and_metadata_share": 0.5,
         "filters": [
             "$leaf",
             {"type": "And", "children": ["$leaf", "$leaf"]},
             {"type": "Or", "children": ["$leaf",
                                         {"type": "Not", "child": "$leaf"}]},
             {"type": "N-Of", "numberOfMatchers": 2, "matchExactly": False,
              "children": ["$leaf", "$leaf", "$leaf"]}]},
        {"name": "group_date", "share": 0.15,
         "action": {"type": "Aggregated", "groupByFields": ["date"]},
         "filters": ["$nuc"]},
        {"name": "group_country", "share": 0.10,
         "action": {"type": "Aggregated", "groupByFields": ["country"]},
         "filters": ["$nuc"]},
        {"name": "mutations", "share": 0.25,
         "action": {"type": "Mutations", "minProportion": 0.05},
         "filters": ["$nuc", {"type": "And", "children": ["$nuc", "$nuc"]}]},
        {"name": "details", "share": 0.10,
         "action": {"type": "Details", "fields": ["key", "date", "country"],
                    "orderByFields": ["date"], "limit": 100},
         "filters": ["$nuc"]},
    ],
    "warmup_requests": 16,
    "check": {"count": 400, "group_date": 100, "group_country": 100,
              "mutations": 80, "details": 60},
}


def actions_spec(spec: dict) -> dict:
    """`spec` with a cell ``dense1m.actions`` whose overrides (``ACTIONS``
    over the counts mix) send this mix."""
    return dict(spec, workloads=spec["workloads"] + [
        {"name": "dense1m.actions", "config": "dense1m", "traffic": "counts",
         "chips": 1, "why": "the tests' mix of every action"}])

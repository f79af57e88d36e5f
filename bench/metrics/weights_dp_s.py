"""``weights_dp_s``: the weight DP's own time in the run, from the
program's ``planner.weights`` spans: the summed time of the misses (a
candidate's ``preprocess``, device synced), less the ``kernels.build``
spans inside them (a kernel's first build)."""
from bench.yardstick import stages


def read(ctx):
    recs = stages.records()
    misses = {r["span"]: r for r in recs if r["name"] == "planner.weights"
              and r.get("attrs", {}).get("hit") is False}
    if not misses:
        return None
    parent = {r["span"]: r["parent"] for r in recs}
    builds = 0.0
    for r in recs:
        if r["name"] != "kernels.build":
            continue
        p = r["parent"]
        while p and p not in misses:
            p = parent.get(p, 0)
        if p:
            builds += r["dur_s"]
    return sum(r["dur_s"] for r in misses.values()) - builds

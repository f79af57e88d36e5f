"""``jobs_per_cohort.samples``: the mean, over the requests answered in
the window, of the jobs sharing each one's tree cohort
(``EstimateResult.fused_jobs``, a count the program keeps)."""


def read(ctx):
    jobs = [r["result"].fused_jobs for r in ctx.records
            if r["result"] is not None]
    return sum(jobs) / len(jobs) if jobs else None

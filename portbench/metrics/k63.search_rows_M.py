"""Millions of query rows times rounds that a job's binary searches over more
than two limbs ran (the growth of the program's searchsorted_limbs.wide_rows
over the job, stats["search.wide_rows"]; None where the program lacks it)."""


def read(ctx):
    vals = [s["search.wide_rows"] / 1e6 for s in ctx.stats if "search.wide_rows" in s]
    return sum(vals) / len(vals) if vals else None

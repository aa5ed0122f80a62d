"""Millions of table rows a streamed job's merges wrote anew
(filter_kmers_streaming's stats, the sum of stream.merge_rows)."""


def read(ctx):
    vals = [sum(s["stream.merge_rows"]) / 1e6 for s in ctx.stats if "stream.merge_rows" in s]
    return sum(vals) / len(vals) if vals else None

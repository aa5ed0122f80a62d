"""``streamed``: one assembly of a read file counted in chunks into one table.

Set-up writes the reads to a FASTQ file.  A job streams it in the traffic's
``chunks`` packed blocks of ``ceil(reads / chunks)`` reads
(``io.stream_fastx_blocks``) into ``filter_kmers_streaming`` under the
traffic's ``merge``, one chunk a block, then runs the library kind's steps:
``remove_censored_exts`` -> ``compress_kmers`` ->
``from_compress_output(...).finish()`` -> ``clean_tips`` -> ``to_gfa``.  A
job that counts another number of chunks raises.

A streamed count equals the one-batch count (filter.rs:151-183; the
program's ``filter_kmers_streaming`` says so too), so the reference, the
sizes, the comparison and the control are the library kind's: the plain
PyTorch ``reference.py``, which imports nothing of the program.  The
program's ``stats=`` goes to the count only while a profiler records, so
that the untraced window makes none of its synchronizations, and only where
``filter_kmers_streaming`` takes it, so that a program without the streamed
count's stages still runs the cell traced and its ``streamed.*`` metrics
read nothing.
"""

from __future__ import annotations

import inspect
import os

from portbench import generate, job

LIBRARY = job.load("library")
reference, sizes, control = LIBRARY.reference, LIBRARY.sizes, LIBRARY.control


class Job(job.Job):
    summarize, check = LIBRARY.Job.summarize, LIBRARY.Job.check

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.chunks = self.traffic["chunks"]
        self.chunk = -(-len(self.reads) // self.chunks)
        self.fastq = os.path.join(self.tmp, "reads.fq")
        generate.write_fastq(self.fastq, self.reads)

    def run(self, span, stats):
        TA, TCL, TC, TF, TG, TP = job.program()
        from tpu_debruijn_torch import stages
        from tpu_debruijn_torch.io import stream_fastx_blocks

        k, dev = self.k, self.device
        blocks = [0]

        def counted(items):
            for item in items:
                blocks[0] += 1
                yield item

        staged = stages.profiling() and "stats" in inspect.signature(
            TF.filter_kmers_streaming).parameters
        with span("count"):
            table = TF.filter_kmers_streaming(
                counted(stream_fastx_blocks(self.fastq, block_reads=self.chunk)), k,
                stranded=False, min_obs=self.cfg["min_obs"], merge=self.traffic["merge"],
                data_reduce="none", chunk_reads=self.chunk, device=dev,
                **({"stats": stats} if staged else {}))
        chunks = len(stats["stream.count_s"]) if staged else blocks[0]
        if chunks != self.chunks:
            raise RuntimeError(f"the count ran {chunks} chunks, not {self.chunks}")
        raw_exts = table.exts  # the censor sets table.exts anew
        with span("censor"):
            TF.remove_censored_exts(table, device=dev)
        with span("compress"):
            nodes = TC.compress_kmers(table, device=dev)
        with span("graph_build"):
            graph = TG.from_compress_output(k, False, nodes).finish(device=dev)
        with span("clean_tips"):
            cleaned = TCL.clean_tips(graph, self.tip, device=dev)
        with span("gfa"):
            cleaned.to_gfa(self.gfa)
        return {"table": table, "raw_exts": raw_exts, "nodes": nodes, "cleaned": cleaned,
                "sizes": (len(table), len(nodes), len(cleaned))}

